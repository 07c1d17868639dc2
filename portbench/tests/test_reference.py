"""The reference against frozen vectors: the generator and the edges of
both codes, and decodes of a few frames (float32 and int8 layered min-sum,
bit-flip) whose bits, success flags and iterations were recorded once."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import channel
from portbench.reference.codes import code, generator_parity
from portbench.reference.decoders import bitflip, layered_minsum, perm_rows

VECTORS = json.loads((Path(__file__).parent / "vectors.json").read_text())


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def edges(name: str) -> np.ndarray:
    c = code(name)
    out = []
    i = np.arange(c.m)
    for row in c.rows:
        for a in row:
            # perm(i): the variable that check i of the block row meets
            var = perm_rows(torch.arange(c.m), a).numpy()
            out += list(zip(a.row * c.m + i, a.col * c.m + var))
    return np.array(sorted(out), dtype=np.int64)


@pytest.mark.parametrize("name", ["TC512", "TM8192"])
def test_tables(name):
    c = code(name)
    assert c.edges == {"TC512": 2048, "TM8192": 30720}[name]
    assert sha(generator_parity(name)) == VECTORS[name]["generator_parity_sha256"]
    assert sha(edges(name)) == VECTORS[name]["edges_sha256"]


@pytest.mark.parametrize("case", VECTORS["cases"], ids=lambda v: f"{v['code']}-{v['kind']}")
def test_decodes(case):
    c = code(case["code"])
    rng = np.random.default_rng(case["seed"])
    data = torch.from_numpy(rng.integers(0, 2, (case["frames"], c.k)).astype(np.uint8))
    noise = torch.from_numpy(rng.standard_normal((case["frames"], c.n)).astype(np.float32))
    uni = torch.from_numpy(rng.random((case["frames"], c.n)).astype(np.float32))
    cw = channel.encode(c.name, data)
    assert sha(cw.numpy()) == case["codeword_sha256"]
    if case["kind"] == "bf":
        r = bitflip(c, cw ^ (uni < case["param"]).to(torch.uint8), case["maxiters"])
    else:
        y = channel.bpsk_awgn(cw, noise, case["param"])
        if case["kind"] == "f32":
            r = layered_minsum(c, y, case["maxiters"])
        else:
            x = torch.clamp(torch.round(y * 16), -128, 127).to(torch.int8)
            r = layered_minsum(c, x, case["maxiters"], (-128, 127))
    assert r.success.tolist() == case["success"]
    assert r.iterations.tolist() == case["iterations"]
    assert sha(r.bits.numpy()) == case["bits_sha256"]


def test_replay_stopping_rule():
    """Budgets: a bits budget of 5 batches launches 5; a bit-error budget
    read as batches drain lets the batches in flight count."""
    def counters(errors):
        return lambda i: channel.Counters(trials=10, bit_errors=errors)

    total, used = channel.replay_point(counters(0), 0, 10, 4, 5 * 40, 100, 4)
    assert (total.trials, used) == (50, 5)
    total, used = channel.replay_point(counters(60), 7, 10, 4, 10 ** 9, 100, 4)
    # two drained batches reach 120 >= 100; the four launched first all count,
    # one more was launched after the first drained (60 < 100)
    assert (total.trials, used) == (50, 5)
