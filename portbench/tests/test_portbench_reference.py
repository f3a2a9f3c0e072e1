"""The plain reference and its control."""

import numpy as np
import torch

from portbench import control, reference, registry
from conftest import tiny


def brute_force(rows, queries, k):
    r = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    q = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    s = q.astype(np.float64) @ r.T.astype(np.float64)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, axis=1), order


def test_exact_topk_equals_numpy_brute_force(cpu, monkeypatch):
    monkeypatch.setattr(reference, "ROW_BLOCK", 700)   # several blocks
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((3000, 48)).astype(np.float32)
    queries = rng.standard_normal((37, 48)).astype(np.float32)
    v, i = reference.exact_topk(rows, queries, 10, cpu)
    want_v, want_i = brute_force(rows, queries, 10)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_allclose(v, want_v, atol=1e-6)
    pair = reference.pair_scores(rows, queries, np.arange(37), i, cpu)
    np.testing.assert_allclose(pair, want_v, atol=1e-6)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, -3.14159265,
                      1e-20, 0.0])
    r = reference.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10 and r[2] == 1.0
    assert r[4] != 0 and r[5] == 0
    bits = r.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()
    assert abs(float(r[3]) + 3.14159265) < 2 ** -10 * 4


def test_the_control_comes_out_not_correct(cpu):
    """The reference in TF32 (its operand rounding emulated on the CPU)
    in the program's place fails each cell's comparison, at the timed
    width."""
    for name in ("flat-1m-768.b64", "ivf-1m-768.b1"):
        cell = tiny(name, dim=768, rows=3000)
        out = control.control_reading(cell, 2 ** 31 + 11, cpu)
        assert out["correct"] is False, out
        assert out["failed"] == 0
        assert out["checks"]["score_gap"]["value"] > \
            out["checks"]["score_gap"]["limit"]


def test_the_reference_imports_nothing_of_the_program():
    import ast
    tree = ast.parse(open(registry.HERE / "reference.py").read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "contextlib", "numpy", "torch"}
