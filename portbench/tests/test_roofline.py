"""The roofline counts against hand counts for TC128 (n = k * 2 = 128,
512 edges, no punctured bits)."""

import pytest

from portbench import roofline


def test_layered_hand_counts():
    # 1000 frames, 7000 sweeps in all: 20 ops an edge and sweep
    ops = 20 * 512 * 7000
    nbytes = 1000 * (128 * 4 + 128 + 1 + 4)
    t, which = roofline.layered(512, 128, 128, 1000, 7000, "float32")
    assert t == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))
    assert which == ("ops" if ops / 67e12 > nbytes / 3.35e12 else "bytes")
    t8, _ = roofline.layered(512, 128, 128, 1000, 7000, "int8")
    assert t8 == pytest.approx(max(23 * 512 * 7000 / 67e12, 1000 * (128 + 128 + 5) / 3.35e12))


def test_bitflip_hand_counts():
    # per iteration: 2 bit operations an edge, 2 a variable, 32 to a word
    t, _ = roofline.bitflip(512, 128, 128, 1000, 3000)
    ops = (2 * 512 + 2 * 128) * 3000 / 32
    assert t == pytest.approx(max(ops / 67e12, 1000 * (128 + 128 + 5) / 3.35e12))


def test_encoder_hand_counts():
    t, which = roofline.encoder(64, 128, 1000)
    assert t == pytest.approx(max(2 * 64 * 64 * 1000 / 1979e12, 1000 * 192 / 3.35e12))
    assert which == "bytes"
    t, which = roofline.encoder(4096, 8192, 8192)
    assert which == "ops" and t == pytest.approx(2 * 4096 * 4096 * 8192 / 1979e12)


def test_share():
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None
