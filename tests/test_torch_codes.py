"""The port's code tables equal the JAX package's, and the port imports no JAX.

labrador_ldpc_tpu_torch keeps its own numpy copy of the code constants (its
"weights"); these tests pin every expanded table equal to the reference
package's, as numpy arrays, for all nine codes.
"""

import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest

from labrador_ldpc_tpu.codes import expand as jexpand
from labrador_ldpc_tpu.codes.params import ALL_CODES, get_code as jget_code

from labrador_ldpc_tpu_torch.codes import expand as texpand
from labrador_ldpc_tpu_torch.codes.params import get_code as tget_code
from labrador_ldpc_tpu_torch.ops.cuda_layered import addend_table

REPO = Path(__file__).resolve().parent.parent
NAMES = [c.value for c in ALL_CODES]


def _qc_rows(s):
    return [
        [(p.row, p.col, p.kind, p.shift, p.theta, tuple(p.phis)) for p in row]
        for row in s.rows
    ]


def _eq_params(name):
    assert tget_code(name).params.__dict__ == jget_code(name).params.__dict__


def _eq_parity_edges(name):
    np.testing.assert_array_equal(texpand.parity_edges(name), jexpand.parity_edges(name))


def _eq_generator_parity_matrix(name):
    np.testing.assert_array_equal(
        texpand.generator_parity_matrix(name), jexpand.generator_parity_matrix(name)
    )


def _eq_decoder_tables(name):
    t, j = texpand.decoder_tables(name), jexpand.decoder_tables(name)
    for f in fields(j):
        if f.name == "code":
            assert t.code.value == j.code.value
        else:
            a, b = getattr(t, f.name), getattr(j, f.name)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


def _eq_qc_structure(name):
    t, j = texpand.qc_structure(name), jexpand.qc_structure(name)
    assert (t.m, t.n_block_rows, t.n_block_cols) == (j.m, j.n_block_rows, j.n_block_cols)
    assert _qc_rows(t) == _qc_rows(j)


TABLES = {
    "params": _eq_params,
    "parity_edges": _eq_parity_edges,
    "generator_parity_matrix": _eq_generator_parity_matrix,
    "decoder_tables": _eq_decoder_tables,
    "qc_structure": _eq_qc_structure,
}


@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("name", NAMES)
def test_table_equals_jax(name, table):
    TABLES[table](name)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_addend_table_reproduces_h(name):
    """The CUDA kernel's per-addend table, read with the kernel's own index
    formula (csrc/layered_minsum.cu perm_index), yields exactly the edges of
    H in the JAX package's expansion."""
    s = texpand.qc_structure(name)
    table, off = addend_table(s)
    M = s.m
    q = M // 4
    i = np.arange(M)
    assert off[0] == 0 and off[-1] == table.shape[0] == sum(len(r) for r in s.rows)
    edges = []
    for row, col, kind, shift, theta, *phis in table.tolist():
        if kind == 0:
            v = (i + shift) & (M - 1)
        else:
            j = i // q
            v = ((theta + j) & 3) * q + ((np.asarray(phis)[j] + i) & (q - 1))
        edges.append(np.stack([row * M + i, col * M + v], axis=1))
    got = np.concatenate(edges)
    want = jexpand.parity_edges(name)
    # same multiset of (check, var) edges (the table is grouped by layer)
    assert sorted(map(tuple, got.tolist())) == sorted(map(tuple, want.tolist()))
    # every layer has two addends on one block column (I+Pi plane sums):
    # the kernel's addend-by-addend posterior writes exist for this case
    assert any(
        len({int(c) for c in table[off[r] : off[r + 1], 1]}) < off[r + 1] - off[r]
        for r in range(len(off) - 1)
    )


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package. Checked in a fresh interpreter: the test process itself has jax
    loaded (tests/conftest.py). Module names are compared exactly, since
    'labrador_ldpc_tpu_torch' starts with the string 'labrador_ldpc_tpu'."""
    probe = (
        "import importlib, pkgutil, sys\n"
        "import labrador_ldpc_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "roots = ('jax', 'jaxlib', 'labrador_ldpc_tpu')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m in roots or any(m.startswith(r + '.') for r in roots))\n"
        "n = sum(1 for m in sys.modules if m.startswith('labrador_ldpc_tpu_torch.'))\n"
        "new = [f'labrador_ldpc_tpu_torch.{m}'\n"
        "       for m in ('ops.cuda_qc', 'ops.qc_minsum', 'ops.minsum', 'ops.sumproduct',\n"
        "                 'ops.cuda_sp', 'ops.routing', 'parallel.mesh', 'parallel.launch',\n"
        "                 'sizes', 'utils.timing', 'utils.tracing', 'serve', 'entry', 'capi',\n"
        "                 'bench', 'bench_suite', 'profile_decode', 'tools.compare',\n"
        "                 'tools.gen_ber_anchors', 'tools.gen_bf_curves',\n"
        "                 'tools.gen_bsc_thresholds', 'tools.gen_gap_table', 'tools.gen_sp_gap')]\n"
        "missing = [m for m in new if m not in sys.modules]\n"
        "print(n, bad, missing)\n"
        "sys.exit(1 if bad or missing or n < 32 else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr
