"""The yardstick's work counts against hand sums at small shapes."""

import pytest

from benchmark import roofline
from benchmark.reference.bobw_qrcan import q_widths
from benchmark.tests.tiny import tiny_cell


def conv(n, h, w, cin, cout, k=3):
    return 2 * n * h * w * cin * cout * k * k


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 339, 510, 64), (120, 48, 48, 64)])
def test_rcab_work(shape):
    n, h, w, c = shape
    ops, nbytes = roofline.rcab_forward_work(n, h, w, c, "bf16")
    assert ops == 2 * conv(n, h, w, c, c)
    assert nbytes == 2 * n * h * w * c * 2 + 2 * 9 * c * c * 2
    ops, nbytes = roofline.rcab_backward_work(n, h, w, c, "bf16")
    assert ops == 4 * conv(n, h, w, c, c)
    assert nbytes == 3 * n * h * w * c * 2 + 2 * 9 * c * c * 2 + 2 * 9 * c * c * 4


def test_rcab_bound_is_the_larger():
    ops, nbytes = roofline.rcab_forward_work(16, 48, 48, 64, "bf16")
    t = roofline.least_seconds(ops, nbytes, "bf16")
    assert t == max(ops / 989e12, nbytes / 3.35e12) == ops / 989e12


def rcan_forward(n, h, w, c, groups, blocks, r):
    block = 2 * conv(n, h, w, c, c) + 2 * n * c * r * 2
    total = conv(n, h, w, 3, c) + groups * (blocks * block + conv(n, h, w, c, c))
    total += conv(n, h, w, c, c)  # body tail
    total += conv(n, h, w, c, 4 * c) + conv(n, 2 * h, 2 * w, c, 4 * c)  # two x2 stages
    return total + conv(n, 4 * h, 4 * w, c, 3)


def test_rcan_flops():
    cfg = tiny_cell("rcan_x4_blind_train_b120")["config"]
    c, g, b = cfg["n_feats"], cfg["n_resgroups"], cfg["n_resblocks"]
    want = rcan_forward(3, 8, 12, c, g, b, c // cfg["reduction"])
    assert roofline.model_flops(cfg, 3, 8, 12, False) == want
    assert roofline.model_flops(cfg, 3, 8, 12, True) == 3 * want


def test_bobw_flops():
    cfg = tiny_cell("bobw_qrcan_x4_blind_train_b192")["config"]
    n, h, w, m = 3, 8, 12, 256
    c, g, b, r = cfg["n_feats"], cfg["n_resgroups"], cfg["n_resblocks"], 1
    q1, q2 = q_widths(c, m)
    per_block = 2 * n * (c + m) * r + 2 * n * r * c + 2 * n * m * q1 + 2 * n * q1 * q2
    trained = rcan_forward(n, h, w, c, g, b, 0) + g * b * per_block
    frozen = (conv(n, h, w, 3, 64) + conv(n, h, w, 64, 64) + conv(n, h // 2, w // 2, 64, 128)
              + conv(n, h // 2, w // 2, 128, 128) + conv(n, h // 4, w // 4, 128, 256)
              + conv(n, h // 4, w // 4, 256, 256))
    assert roofline.model_flops(cfg, n, h, w, False) == trained + frozen
    assert roofline.model_flops(cfg, n, h, w, True) == 3 * trained + frozen


def test_full_rcan_step_flops():
    """RCAN x4 at batch 120 of 48 x 48: about 26.4 TFLOP a step."""
    cfg = tiny_cell("rcan_x4_blind_train_b120")["config"]
    cfg.update(n_feats=64, n_resgroups=10, n_resblocks=20)
    assert roofline.model_flops(cfg, 120, 48, 48, True) == 3 * rcan_forward(
        120, 48, 48, 64, 10, 20, 4)
    assert 26.0e12 < roofline.model_flops(cfg, 120, 48, 48, True) < 26.8e12
