"""The reference's round-3d review cases (tests/test_review_r3d.py) on the
port: the CLI's prompt migration and agent observation, the neighbors
endpoint's direction, the CLI's remote branches and its reused context.
Rewrites: the CLI module the cases load by name is the port's
(cortex_tpu_torch.cli.main); the CLI runs with `--device cpu` (its
in-process main([...]) and the parser of the reused context); the HTTP
scenario is the port's run of the reference's HTTP cases
(test_torch_http.py), not tests/test_http.py. Every Cortex on the CPU."""

from torch_reference_cases import CLI_ON_CPU, port_cases

exec(port_cases("test_review_r3d.py", CLI_ON_CPU + (
    (r'import_module\("cortex_tpu\.cli\.main"\)',
     'import_module("cortex_tpu_torch.cli.main")'),
    (r"parse_args\(\s*\[", 'parse_args(["--device", "cpu", '),
    (r"from tests\.test_http import scenario",
     "from test_torch_http import scenario"),
), cpu_calls=(r"\bCortex\.in_memory",)), globals())


def test_cases_run_on_the_port():
    assert _main_mod().__name__ == "cortex_tpu_torch.cli.main"  # noqa: F821
