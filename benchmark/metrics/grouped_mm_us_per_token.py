"""Device time of the MoE grouped product in the traced window over the
output tokens streamed in it, in microseconds: every call the window
made, in decode steps and prefill chunks alike. The grouped product is
PyTorch's ``torch._grouped_mm`` (a CUTLASS kernel behind PyTorch's
``enable_3x_kernel_for_sm9x``, with its ``prepare_grouped_gemm_data``
set-up kernel) or a hand-written kernel with ``grouped_mm`` in its name.

A share of the roofline would need the experts each call reads, which
depend on the router and cannot be seen from outside the program yet."""

from harness import window


def is_grouped_product(name: str) -> bool:
    return any(k in name for k in ("enable_3x_kernel_for_sm9x", "prepare_grouped_gemm_data", "grouped_mm"))


def read(ctx):
    n = window.tokens(ctx)
    if ctx.trace is None or not n or not ctx.shape.experts:
        return None
    calls, seconds = ctx.trace.time_of(is_grouped_product)
    if not calls:
        return None
    return 1e6 * seconds / n
