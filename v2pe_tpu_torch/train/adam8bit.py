"""Block-wise 8-bit Adam moments (port of ``v2pe_tpu/train/adam8bit.py``).

The first and second moments are stored as int8 with one float32 scale per
block of ``BLOCK`` values: ``m`` on a symmetric linear code (scale =
absmax / 127), ``v`` on a sqrt code (code = round(127 * sqrt(v / absmax)),
scale = absmax / 127^2, dequantized by squaring). Each step dequantizes,
runs plain Adam in fp32 and requantizes, in chunks of about ``CHUNK_ELEMS``
values so that the fp32 temporaries stay small. Plain tensor code: the JAX
version has no Pallas kernel either.

The blocks run over a leaf of the JAX tree flattened in its own layout (a
stacked (L, ...) leaf; a linear's (in, out) kernel). The optimizer
(``train/optimizer.py``) hands each update a flat vector in that layout, so
codes and scales match the JAX state element for element.
"""

from __future__ import annotations

import torch

BLOCK = 256
CHUNK_ELEMS = 4 * 2 ** 20
# the scales multiply by these fp32 reciprocals, as XLA compiles the JAX
# version's divisions by the constants 127 and 127^2 (so codes and scales
# come out equal to the bit)
INV_127 = float(torch.tensor(1 / 127.0, dtype=torch.float32))
INV_127_SQ = float(torch.tensor(1 / 127.0 ** 2, dtype=torch.float32))


def zeros(numel: int, device=None) -> dict:
    """The state of a leaf of ``numel`` values: every moment 0."""
    nb = -(-numel // BLOCK)
    return {"m_code": torch.zeros(numel, dtype=torch.int8, device=device),
            "m_scale": torch.zeros(nb, dtype=torch.float32, device=device),
            "v_code": torch.zeros(numel, dtype=torch.int8, device=device),
            "v_scale": torch.zeros(nb, dtype=torch.float32, device=device)}


def _blocks(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x zero-padded to rows * BLOCK values, as (rows, BLOCK)."""
    pad = rows * BLOCK - x.numel()
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(rows, BLOCK)


@torch.no_grad()
def update(g: torch.Tensor, state: dict, offset: int, *, b1: float,
           b2: float, eps: float, bc1: torch.Tensor,
           bc2: torch.Tensor) -> torch.Tensor:
    """One Adam step of the flat fp32 gradient ``g``, which covers values
    [offset, offset + g.numel()) of the leaf (``offset`` a multiple of
    BLOCK). The codes and scales of those values are updated in place; the
    fp32 update m̂ / (sqrt(v̂) + eps) is returned. bc1/bc2 are the bias
    corrections 1 - b^count as float32 scalars."""
    if offset % BLOCK:
        raise ValueError(f"offset {offset} is not a multiple of {BLOCK}")
    n = g.numel()
    out = torch.empty_like(g)
    nb = -(-n // BLOCK)
    rows = min(nb, max(1, CHUNK_ELEMS // BLOCK))
    for r0 in range(0, nb, rows):
        r1 = min(r0 + rows, nb)
        e0, e1 = r0 * BLOCK, min(r1 * BLOCK, n)
        s0, s1 = offset // BLOCK + r0, offset // BLOCK + r1
        ce = slice(offset + e0, offset + e1)
        gf = _blocks(g[e0:e1], r1 - r0)
        m = _blocks(state["m_code"][ce], r1 - r0).float() \
            * state["m_scale"][s0:s1, None]
        v = _blocks(state["v_code"][ce], r1 - r0).float() ** 2 \
            * state["v_scale"][s0:s1, None]
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf * gf
        out[e0:e1] = ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                      ).reshape(-1)[:e1 - e0]
        msc = m.abs().amax(dim=1) * INV_127
        msafe = torch.where(msc > 0, msc, 1.0)
        mcode = torch.clamp(torch.round(m / msafe[:, None]), -127, 127)
        vmax = v.amax(dim=1)
        vsafe = torch.where(vmax > 0, vmax, 1.0)
        vcode = torch.clamp(torch.round(127.0 * torch.sqrt(v / vsafe[:, None])),
                            0, 127)
        state["m_code"][ce] = mcode.to(torch.int8).reshape(-1)[:e1 - e0]
        state["v_code"][ce] = vcode.to(torch.int8).reshape(-1)[:e1 - e0]
        state["m_scale"][s0:s1] = msc
        state["v_scale"][s0:s1] = vmax * INV_127_SQ
    return out
