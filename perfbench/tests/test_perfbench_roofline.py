"""The model FLOPs that the shares of the peak count."""

import json

from conftest import ROOT

from perfbench import roofline


def test_model_flops():
    cfg = json.loads((ROOT / "perfbench/configs/minilm-l6-1m.json").read_text())
    # MiniLM-L6: 6 x (4 x (384^2 + 384) + 2 x 384 x 1536 + 1536 + 384 + 4 x 384)
    assert roofline.encoder_params(cfg) == 10_646_784
    one = roofline.encoder_forward_flops(cfg, [10])
    assert one == 2 * 10_646_784 * 10 + 4 * 384 * 6 * 100
    step = roofline.train_step_flops(cfg, [10, 10], [20, 20])
    fwd = roofline.encoder_forward_flops(cfg, [10, 10]) + roofline.encoder_forward_flops(cfg, [20, 20])
    assert step == 3 * fwd + 3 * 2 * 4 * 384
