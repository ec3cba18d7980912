"""The limit that `chip_smoke.py` and the card tests hold bf16 K1, K3 and K4
to (`chip_smoke.bf16_excess`): it passes an output that differs from the f32
result only by a sound bf16 kernel's rounding, and fails one that skips a
64-row tile, at the sequence lengths of the paths. Plain PyTorch on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from open_genie_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_plain,
    flash_attention_plain,
)

TILE = 64
CASES = [(256, 64), (1024, 16), (4096, 16)]  # (N, D) of the dynamics and latent action


def _inputs(n, d):
    g = torch.Generator().manual_seed(n + d)
    return [torch.randn(1, n, d, generator=g).bfloat16().float() for _ in range(4)]


def _skip(n, tile):
    keep = torch.ones(n, dtype=torch.bool)
    keep[tile * TILE:(tile + 1) * TILE] = False
    return keep


@pytest.mark.parametrize("n,d", CASES)
def test_bf16_limit_passes_rounding_and_fails_a_skipped_key_tile(n, d):
    """K1's o: p rounded to bf16 before P.V and o rounded to bf16 pass; the
    same with one key tile left out fails."""
    q, k, v, _ = _inputs(n, d)
    scale = d ** -0.5
    ref, _ = flash_attention_plain(q, k, v, scale)

    def kernel_like(keys):
        s = q @ k[:, keys].transpose(-1, -2) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = p.bfloat16().float() @ v[:, keys] / p.sum(-1, keepdim=True)
        return o.bfloat16()

    assert chip_smoke.bf16_excess(kernel_like(torch.ones(n, dtype=torch.bool)), ref) <= 1
    for tile in (0, n // TILE - 1):
        assert chip_smoke.bf16_excess(kernel_like(_skip(n, tile)), ref) > 10


@pytest.mark.parametrize("n,d", CASES)
def test_bf16_limit_passes_rounding_and_fails_a_skipped_query_tile(n, d):
    """K3's dk and dv: the twin's result rounded to bf16 passes; the same
    with one query tile's contributions left out (its dO zero) fails."""
    q, k, v, do = _inputs(n, d)
    scale = d ** -0.5
    o, lse = flash_attention_plain(q, k, v, scale)
    o = o.bfloat16().float()
    _, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    assert chip_smoke.bf16_excess(dk.bfloat16(), dk) <= 1
    assert chip_smoke.bf16_excess(dv.bfloat16(), dv) <= 1
    for tile in (0, n // TILE - 1):
        skipped = do * _skip(n, tile)[:, None]
        _, dk_s, dv_s = flash_attention_bwd_plain(q, k, v, o, lse, skipped, scale)
        assert chip_smoke.bf16_excess(dk_s.bfloat16(), dk) > 10
        assert chip_smoke.bf16_excess(dv_s.bfloat16(), dv) > 10
