from qserve_tpu_torch.eval.ppl import evaluate_ppl, tokenize_text  # noqa: F401
