"""SQ8 / SQ16 scalar quantization of rows and queries (port of
turdb_tpu/ops/quantize.py `sq8_encode` / `sq8_decode`, and of the query
quantization and row encodings inside turdb_tpu/models/ivf.py).

    x ≈ min + scale·u,   u ∈ [0, 255],   scale = (max − min) / 255

The IVF store keeps the codes centred (c = u − 128, int8) with
m′ = min + 128·scale, so that q·x̂ = m′·Σq + scale·(q·c), and, in the
compact store, an SQ16 copy u16 ∈ [0, 65535] on the same (min, scale).
Every function rounds as the reference does (`torch.round` and
`jnp.round` both round half to even, and divisions stay divisions), so
the codes are the reference's bit for bit.

The HNSW graph store (`Sq8Rows`) keeps u8 or u16 codes on the row's own
(min, scale) with 255 or 65535 steps.

`sq8_search` is the asymmetric k-NN of f32 queries over a u8 store
(K11 `sq8_scan` and a K2 merge on the card).
"""

from __future__ import annotations

import torch

SQ16_RATIO = 255.0 / 65535.0   # SQ16 step per SQ8 step (ivf.py `s16`)


class Sq8Rows:
    """The HNSW graph's SQ8 / SQ16 vector store (port of the reference's
    `Sq8Rows`, models/hnsw.py:105): codes [cap, d] (uint8, or the uint16
    codes as int16 bits), per-row mins and scales [cap]. `rows[ids]` is
    the gather, dequantized as one fused multiply-add `min + scale·code`
    (`torch.addcmul`), which is what the reference's compiled search
    computes; `dense()` rounds the product and the sum apart, as the
    reference's eager `dense()` does. Both are the reference's bit for bit
    on the CPU (tests/test_torch_hnsw_sq.py)."""

    def __init__(self, codes: torch.Tensor, mins: torch.Tensor, scales: torch.Tensor):
        if codes.dtype not in (torch.uint8, torch.int16):
            raise TypeError(f"Sq8Rows codes must be uint8 or int16 (the uint16 bits), "
                            f"got {codes.dtype}")
        self.codes, self.mins, self.scales = codes, mins, scales

    @property
    def bits(self) -> int:
        return 8 if self.codes.dtype == torch.uint8 else 16

    @property
    def shape(self):
        return self.codes.shape

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.codes, self.mins, self.scales))

    def _values(self, c):
        return c.float() if self.bits == 8 else (c.to(torch.int32) & 0xFFFF).float()

    def __getitem__(self, ids):
        return torch.addcmul(self.mins[ids][..., None], self.scales[ids][..., None],
                             self._values(self.codes[ids]))

    def dense(self) -> torch.Tensor:
        return self.mins[:, None] + self.scales[:, None] * self._values(self.codes)


def _encode(x: torch.Tensor, steps: int):
    """Per-row min, scale (max − min) / steps, and the codes
    clip(round((x − min) / scale), 0, steps) as floats."""
    x = x.float()
    mins = torch.amin(x, dim=-1)
    scales = (torch.amax(x, dim=-1) - mins) / float(steps)
    safe = torch.where(scales == 0, 1.0, scales)
    return torch.clamp(torch.round((x - mins[:, None]) / safe[:, None]), 0, steps), mins, scales


def _u16_bits(u: torch.Tensor) -> torch.Tensor:
    """Codes in [0, 65535] -> int16 holding their uint16 bits."""
    u = u.to(torch.int32)
    return torch.where(u >= 32768, u - 65536, u).to(torch.int16)


def sq_rows_encode(x: torch.Tensor, bits: int) -> Sq8Rows:
    """Rows [N, d] -> their `Sq8Rows` with 2**bits − 1 steps (bits 8 or
    16): `_quantize` of the reference's HnswIndex, whose eager ops divide."""
    codes, mins, scales = _encode(x, (1 << bits) - 1)
    return Sq8Rows(codes.to(torch.uint8) if bits == 8 else _u16_bits(codes), mins, scales)


def sq8_encode(x: torch.Tensor):
    """[N, d] f32 -> (codes uint8 [N, d], mins [N], scales [N])."""
    codes, mins, scales = _encode(x, 255)
    return codes.to(torch.uint8), mins, scales


def sq8_decode(codes: torch.Tensor, mins: torch.Tensor, scales: torch.Tensor):
    return mins[:, None] + scales[:, None] * codes.float()


def sq8_store(x: torch.Tensor):
    """Rows -> the IVF store's (centred int8 codes, m′, scales) and the
    row minima the SQ16 encoding shares."""
    codes, mins, scales = sq8_encode(x)
    centred = (codes.to(torch.int16) - 128).to(torch.int8)
    return centred, mins + 128.0 * scales, scales, mins


def sq16_encode(x: torch.Tensor, mins: torch.Tensor, scales: torch.Tensor):
    """Rows on their SQ8 (min, scale) -> SQ16 codes as int16 holding the
    uint16 bits (torch has few uint16 operators; `& 0xFFFF` widens back)."""
    s16 = scales * SQ16_RATIO
    safe16 = torch.where(s16 == 0, 1.0, s16)
    return _u16_bits(torch.clamp(torch.round((x.float() - mins[:, None]) / safe16[:, None]),
                                 0, 65535))


def sq16_decode(u16: torch.Tensor, mins: torch.Tensor, scales: torch.Tensor):
    """SQ16 codes [..., d] (int16 holding uint16 bits) with the store's m′
    and scales [...] -> f32 rows `(m′ − 128·scale) + (scale·255/65535)·u`."""
    base = mins - 128.0 * scales
    s16 = scales * SQ16_RATIO
    return base[..., None] + s16[..., None] * (u16.to(torch.int32) & 0xFFFF).float()


def quantize_queries(q: torch.Tensor):
    """Per-row symmetric int8 query quantization of the sq8 probe:
    qs = max(max|q|, 1e-30) / 127, qc = clip(round(q / qs), −127, 127),
    and q_sum = Σq. Returns (qc int8 [B, d], qs [B], q_sum [B])."""
    q = q.float()
    qs = torch.clamp_min(torch.amax(torch.abs(q), dim=-1), 1e-30) / 127.0
    qc = torch.clamp(torch.round(q / qs[:, None]), -127, 127).to(torch.int8)
    return qc.contiguous(), qs, torch.sum(q, dim=-1)


def sq8_search(queries: torch.Tensor, codes: torch.Tensor, mins: torch.Tensor,
               scales: torch.Tensor, valid: torch.Tensor, k: int):
    """Asymmetric L2² k-NN over the quantized store (the reference's
    `sq8_search`, ops/quantize.py:42-76): queries [B, d] f32, codes
    [N, d] uint8, mins / scales [N], valid [N] bool. With x̂ = min +
    scale·u, `‖q‖² − 2·q·x̂ + ‖x̂‖²` clamped at 0 and +inf where not valid.
    Returns ([B, k] distances ascending, [B, k] int32 row ids, -1 where
    +inf); ties go to the lower row."""
    from turdb_tpu_torch.kernels import sq8_scan   # kernels imports this module

    q = queries.float().contiguous()
    return sq8_scan(q, torch.sum(q * q, dim=-1), torch.sum(q, dim=-1), codes.contiguous(),
                    mins.float().contiguous(), scales.float().contiguous(),
                    valid.to(torch.bool).contiguous(), k)
