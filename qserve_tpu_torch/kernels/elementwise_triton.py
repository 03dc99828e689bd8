"""Triton source of the fused elementwise/quant kernel (K1).

Imported only by `elementwise.launch`, on the card: this module imports
triton at the top, and the CPU tests must be able to import the port
without it.
"""

import triton
import triton.language as tl

try:
    import triton.language.extra.libdevice as tld
except ImportError:  # older triton keeps libdevice under the cuda backend
    import triton.language.extra.cuda.libdevice as tld


@triton.jit
def fused_quant_kernel(
    x_ptr, d_ptr, w_ptr, h_ptr, q_ptr, s_ptr, sum_ptr,
    W, eps,
    MODE: tl.constexpr, BLOCK: tl.constexpr,
):
    """One program per token row of width W (the quantized width).

    MODE 0: y = x                       (x [T, W])
    MODE 1: y = rmsnorm(x) * w          (x [T, W], w [W])
    MODE 2: h = bf16(x + d); y = rmsnorm(h) * w, h stored
    MODE 3: y = silu(g) * u             (x = [g | u], [T, 2W])
    then q = clamp(rint(y / scale), -128, 127), scale = max(amax, 1e-8) / 127,
    act-sum = scale * sum(q). Divisions and square roots are IEEE (div_rn,
    sqrt_rn; Triton's `/` is approximate) and rint rounds half to even, so
    the codes equal quant/qoq.py's.
    """
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    m = cols < W
    if MODE == 3:
        g = tl.load(x_ptr + row * 2 * W + cols, mask=m, other=0.0).to(tl.float32)
        u = tl.load(x_ptr + row * 2 * W + W + cols, mask=m, other=0.0).to(tl.float32)
        y = tld.div_rn(g, 1.0 + tld.exp(-g)) * u
    else:
        x = tl.load(x_ptr + row * W + cols, mask=m, other=0.0).to(tl.float32)
        if MODE == 2:
            d = tl.load(d_ptr + row * W + cols, mask=m, other=0.0).to(tl.float32)
            hb = (x + d).to(tl.bfloat16)
            tl.store(h_ptr + row * W + cols, hb, mask=m)
            x = hb.to(tl.float32)  # normalize the ROUNDED residual
        if MODE == 0:
            y = x
        else:
            var = tld.div_rn(tl.sum(x * x, axis=0), W * 1.0)
            r = tld.div_rn(1.0, tld.sqrt_rn(var + eps))
            w = tl.load(w_ptr + cols, mask=m, other=0.0).to(tl.float32)
            y = x * r * w
    amax = tl.max(tl.abs(y), axis=0)
    scale = tld.div_rn(tl.maximum(amax, 1e-8), 127.0)
    qf = tld.rint(tld.div_rn(y, scale))
    qf = tl.minimum(tl.maximum(qf, -128.0), 127.0)
    tl.store(q_ptr + row * W + cols, qf.to(tl.int8), mask=m)
    tl.store(s_ptr + row, scale)
    tl.store(sum_ptr + row, tl.sum(tl.where(m, qf, 0.0), axis=0) * scale)
