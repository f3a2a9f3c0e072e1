"""The reference's ShardedFlatIndex cases (tests/test_sharded_index.py)
on the port: a mesh of eight `cpu` devices in place of the reference's
eight virtual host devices, the single-device index on the CPU, and the
port's BruteForceIndex as the oracle."""

from torch_reference_cases import port_cases

exec(port_cases("test_sharded_index.py", [
    (r"\bTpuFlatIndex\b", "TorchFlatIndex"),
    (r"build_mesh\((\d+)\)", r'build_mesh(\1, devices=["cpu"] * 8)'),
    (r"Cortex\.in_memory\(cfg\)", 'Cortex.in_memory(cfg, device=["cpu"] * 8)'),
    (r'Cortex\.open\(str\(tmp_path / "cortex\.db"\), cfg\)',
     'Cortex.open(str(tmp_path / "cortex.db"), cfg, device=["cpu"] * 8)'),
], cpu_calls=(r"\bTorchFlatIndex",)), globals())


def test_cases_run_on_the_port(mesh8):  # noqa: F811
    idx = ShardedFlatIndex(DIM, mesh8)  # noqa: F821
    assert type(idx).__module__ == "cortex_tpu_torch.parallel.sharded_index"
    assert [str(d) for d in mesh8.devices.flat] == ["cpu"] * 8
    assert idx.index_info()["mesh"] == {"shards": 8, "replicas": 1}
    assert BruteForceIndex.__module__ == "cortex_tpu_torch.vector.index"  # noqa: F821
