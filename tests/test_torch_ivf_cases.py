"""The reference's IVF index cases (tests/test_ivf.py) on the port:
exactness at full probe, recall, filters, mutation, lifecycle, Cortex
with the IVF index, query chunking, shape-stable rebuilds, slot growth
and the snapshot boot, every index and Cortex on the CPU, the port's
BruteForceIndex as the oracle.

Rewrites:
  * The snapshot-boot cases make k-means raise to show a restored boot
    does not retrain; the port's k-means is `vector.ivf.kmeans`, the
    reference's `_kmeans_device`.
  * The chunking case clears the reference's XLA trace caches
    (`_ivf_search.clear_cache()`) so the budget it patches is read
    again; the port reads GATHER_BUDGET_BYTES at every call and has no
    trace cache, so the clears go.

Left out, by name:
  * TestSlotGrowth.test_pad_meta_axis_matches_build_meta: asserts the
    padding of the Pallas kernel's packed meta plane (`_pad_meta_axis`,
    a jax.numpy op), which the port does not have.
  * TestSlotGrowth.test_warm_next_slot_programs_counts,
    TestScatterWarmAndChunking.test_warm_scatter_buckets_is_shape_only
    and test_warm_declines_below_slot_threshold: XLA compile warmers.
  * TestScatterWarmAndChunking.test_large_dirty_waves_chunk_and_stay_exact:
    monkeypatches MAX_SCATTER_ROWS, the reference's scatter bucket, which
    the port does not have.
  * TestBenchScriptRunnable.test_ivf_scale_bench_tiny_cpu and
    test_ivf_scale_bench_graph_hops_cpu: they run the reference's
    benchmark script (benches/ivf_scale_bench.py), which imports only
    cortex_tpu.
"""

from torch_reference_cases import drop_cases, port_cases

exec(port_cases("test_ivf.py", [
    (r"\bTpuIvfIndex\b", "TorchIvfIndex"),
    (r"\bTpuFlatIndex\b", "TorchFlatIndex"),
    (r'"_kmeans_device"', '"kmeans"'),
    (r"ivf_mod\._ivf_search\.clear_cache\(\)\n\s+"
     r"ivf_mod\._ivf_search_hostbias\.clear_cache\(\)", "pass"),
], cpu_calls=(r"\bTorchIvfIndex", r"\bCortex\.in_memory")), globals())

XLA = "asserts an XLA compile warmer"
BENCH = "runs the reference's benchmark script, which imports cortex_tpu"
drop_cases(globals(), {
    "TestSlotGrowth.test_pad_meta_axis_matches_build_meta":
        "asserts the Pallas kernel's packed meta plane",
    "TestSlotGrowth.test_warm_next_slot_programs_counts": XLA,
    "TestScatterWarmAndChunking.test_warm_scatter_buckets_is_shape_only":
        XLA,
    "TestScatterWarmAndChunking.test_warm_declines_below_slot_threshold":
        XLA,
    "TestScatterWarmAndChunking.test_large_dirty_waves_chunk_and_stay_exact":
        "monkeypatches the reference's scatter bucket (MAX_SCATTER_ROWS)",
    "TestBenchScriptRunnable.test_ivf_scale_bench_tiny_cpu": BENCH,
    "TestBenchScriptRunnable.test_ivf_scale_bench_graph_hops_cpu": BENCH,
})


def test_cases_run_on_the_port():
    ivf, oracle = build_pair(clustered(64, dim=48), nlist=4,  # noqa: F821
                             nprobe=4)
    assert type(ivf).__module__ == "cortex_tpu_torch.vector.ivf"
    assert str(ivf._corpus._device) == "cpu"
    assert type(oracle).__module__ == "cortex_tpu_torch.vector.index"
