"""Model FLOPs of the training steps in the traced slice (forward and
backward of both towers over the real tokens, no recomputation counted)
over the bf16 peak, 989 TFLOP/s, times the slice (%)."""

from perfbench.readers import mfu_pct


def read(data):
    return mfu_pct(data)
