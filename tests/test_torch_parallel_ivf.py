"""The reference's ShardedIvfIndex cases (tests/test_sharded_ivf.py) on
the port: a mesh of eight `cpu` devices, the single-device IVF index on
the CPU, and the port's BruteForceIndex as the oracle."""

from torch_reference_cases import port_cases

exec(port_cases("test_sharded_ivf.py", [
    (r"from cortex_tpu\.vector import TpuIvfIndex",
     "from cortex_tpu.vector import TorchIvfIndex as TpuIvfIndex"),
    (r"build_mesh\((\d+)\)", r'build_mesh(\1, devices=["cpu"] * 8)'),
    (r"Cortex\.in_memory\(cfg\)", 'Cortex.in_memory(cfg, device=["cpu"] * 8)'),
], cpu_calls=(r"\bTpuIvfIndex",)), globals())


def test_cases_run_on_the_port(mesh):  # noqa: F811
    idx = ShardedIvfIndex(DIM, mesh, nlist=8, nprobe=8)  # noqa: F821
    assert type(idx).__module__ == "cortex_tpu_torch.parallel.sharded_ivf"
    assert idx.index_info()["mesh"] == {"shards": 8, "replicas": 1}
    assert BruteForceIndex.__module__ == "cortex_tpu_torch.vector.index"  # noqa: F821
