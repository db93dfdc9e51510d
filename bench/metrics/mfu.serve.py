"""The whole serving step's share of the card: the served model's FLOPs
for every prompt and generated token of the window (`work.model_flops`),
at the bfloat16 tensor-core peak, over the window's wall time.  Moves
`serve_tokens_per_s`."""

from work import PEAKS


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return 100.0 * ctx["model_flops"] / (ctx["window_s"] * PEAKS["bf16_ops_per_s"])
