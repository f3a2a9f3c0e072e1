"""The reference's tokenizer cases (tests/test_tokenizer.py) on the port's
copy of the WordPiece tokenizer: parity with transformers' BertTokenizer,
the vocabulary carried in the npz, and the single-file embedder
(JaxEncoderEmbedder is the port's TorchEncoderEmbedder, on the CPU)."""

from torch_reference_cases import port_cases

exec(port_cases("test_tokenizer.py", [
    (r"\bJaxEncoderEmbedder\b", "TorchEncoderEmbedder"),
], cpu_calls=(r"\bTorchEncoderEmbedder",)), globals())


def test_cases_run_on_the_port():
    assert WordPieceTokenizer.__module__ == (  # noqa: F821
        "cortex_tpu_torch.models.tokenizer")
