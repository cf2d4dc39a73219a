"""Share of the traced slice's device time in the f32 -> bf16 conversion
kernels (`bfloat16_copy_kernel`, the one whose name gives its dtypes, %):
the encoder's per-call casts of its f32 weights and the activations' casts
down, which keeping bf16 weights from load time would cut.  Layout copies
and other casts (`direct_copy_kernel`) are not counted."""

from perfbench.readers import share_pct


def read(data):
    return share_pct(data, ("bfloat16_copy_kernel",))
