"""The reference's 2D (replica, shard) mesh cases (tests/test_mesh2d.py)
on the port: meshes of eight `cpu` devices; the primitives' cases build
their inputs with numpy where the reference uses jax.numpy (the port's
shard_corpus and sharded_engine_step take numpy or torch arrays and lay
them out themselves, so the reference's jax.device_put of the edge
arrays goes), and the port's BruteForceIndex is the oracle."""

from torch_reference_cases import port_cases

exec(port_cases("test_mesh2d.py", [
    (r"\bTpuFlatIndex\b", "TorchFlatIndex"),
    (r"import jax\n(\s+)import jax\.numpy as jnp\n\s+from jax\.sharding "
     r"import NamedSharding, PartitionSpec as P\n",
     r"import numpy as jnp\n"),
    (r"\n\s+spec = NamedSharding\(mesh, P\(\"shard\"\)\)", ""),
    (r"jax\.device_put\((jnp\.asarray\(\w+\)), spec\)", r"\1"),
    (r"import jax\.numpy as jnp", "import numpy as jnp"),
    (r"build_mesh\((\d+)(, replicas=\w+)?\)",
     r'build_mesh(\1\2, devices=["cpu"] * 8)'),
    (r"Cortex\.in_memory\(cfg\)", 'Cortex.in_memory(cfg, device=["cpu"] * 8)'),
], cpu_calls=(r"\bTorchFlatIndex",)), globals())


def test_cases_run_on_the_port():
    m = build_mesh(8, replicas=2, devices=["cpu"] * 8)  # noqa: F821
    assert type(m).__module__ == "cortex_tpu_torch.parallel.sharding"
    assert m.shape == {"replica": 2, "shard": 4} and m.virtual
    assert BruteForceIndex.__module__ == "cortex_tpu_torch.vector.index"  # noqa: F821
