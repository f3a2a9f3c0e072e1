"""The least work of a call, counted from the shapes, against hand
arithmetic."""

import json

import pytest

from portbench import registry, roofline


def least(config, traffic):
    entry = next(c for c in registry.benchmark()["configs"]
                 if c["name"] == config)
    with open(registry.ROOT / entry["file"]) as f:
        cfg = json.load(f)
    return registry.system(cfg["system"]).least_work(
        cfg, registry.traffic(traffic))


def test_flat_counts():
    # 1M rows of 768 int8 + a float32 scale; 64 queries of 768 floats;
    # 64 x 10 result rows re-read in float32; 64 x 10 ids and scores
    nbytes, ops = least("flat-1m-768", "b64")
    assert nbytes == 1_000_000 * 772 + 64 * 3072 + 640 * 3072 + 640 * 8
    assert ops == 2 * 64 * 1_000_000 * 768
    nbytes, ops = least("flat-1m-768", "b1")
    assert nbytes == 772_000_000 + 3072 + 10 * 3072 + 80
    assert ops == 1_536_000_000


def test_ivf_counts():
    # one query's 128 lists of 1M / 1024 rows
    probed = 128 * 1_000_000 / 1024
    assert probed == 125_000
    nbytes, ops = least("ivf-1m-768", "b64")
    assert nbytes == pytest.approx(125_000 * 772 + 64 * 3072 + 640 * 3072
                                   + 640 * 8)
    assert ops == pytest.approx(2 * 64 * 125_000 * 768)


def test_bound_takes_the_larger_of_bytes_and_operations():
    ms, by = roofline.bound_ms(3.35e9, 1.0, roofline.INT8_OPS_PER_S)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = roofline.bound_ms(1.0, 1.979e12, roofline.INT8_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(1.0)
    # the flat batch-64 call is bound by its bytes: 0.231 ms
    ms, by = roofline.bound_ms(*least("flat-1m-768", "b64"),
                               roofline.INT8_OPS_PER_S)
    assert by == "bytes" and ms == pytest.approx(0.2311, abs=1e-4)
