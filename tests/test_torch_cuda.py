"""The port's CUDA kernels against their plain twins, on the card, the
train kernels, the conv stack's gradient, the log-mel kernel and the
decode-step attention kernel (alone, in its cached form on the decoder's
layouts, inside the decoder, and its max-probability output at the beam's
and the TTS decoder's shapes; its query-tiled kernel at WavLM's long
queries) included,
the inference kernel's refusal to drop a gradient and the wrappers'
refusals of inputs their kernels do not take; the bf16 attention forwards'
row statistics, their bit-equal scores with the backward's, and a forward
and backward through the encoder's row-padded band.

Marked ``cuda``; each test skips when no card is present.  This file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs with ``python -m pytest --noconftest -q tests/test_torch_cuda.py``.

Tolerances: f32 1e-4 absolute (sums in another order); bf16 3e-2 of
max |ref| (one bf16 rounding of probabilities or activations); log10-mel
2e-3 absolute (the JAX spec's); the bf16 train forward's row statistics
1e-4 relative plus 1e-5 absolute (f32 scores summed in another order by
wgmma; the absolute term covers row maxima near 0).
"""

import pytest
import torch

from speecht5_tpu_torch.models.attention import band_from_table
from speecht5_tpu_torch.ops import cuda_kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, dtype):
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        assert err <= 3e-2 * ref.float().abs().max().item(), err


def _band(table, T, M, dtype, card, padded):
    """The band on the card: contiguous, or the encoder's row-padded view."""
    return band_from_table(table.to(card), T, M, dtype=dtype,
                           row_multiple=8 if padded else 1)


def _lengths(N, T, card):
    """Ragged lengths with rows of length 0, 1 and T."""
    lens = ([T, 0, 1, T // 2, T - 1, 33, 613 % T, T, 64, 65, 128, T // 3] * N)[:N]
    return torch.tensor(lens, dtype=torch.int32, device=card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Dh,N,padded", [
    (77, 16, 6, False), (199, 64, 6, False), (1024, 64, 6, False),
    (130, 32, 200, True),      # N not a multiple of 64, T % 64 != 0
    (799, 64, 12, True),       # the served chunk's shape, as the encoder gives it
    (128, 64, 12, True),       # the /tts text encoder's token bucket
])
def test_attention_kernel_matches_twin(card, dtype, T, Dh, N, padded):
    """The inference attention against its twin, ragged lengths with rows
    of length 0, 1 and T; bf16 runs the wgmma kernels (bias pass and main
    loop: two launches), f32 the CUDA-core kernel (one)."""
    g = torch.Generator().manual_seed(T)
    M = 16
    q, k, v = (torch.randn(N, T, Dh, generator=g) * s for s in (Dh ** -0.5, 1, 1))
    table = torch.randn(2 * M, Dh, generator=g) * 0.2
    args = [t.to(dtype).to(card) for t in (q, k, v)]
    args.append(_band(table, T, M, dtype, card, padded))
    lengths = _lengths(N, T, card)
    before = K.banded_flash_attention.launches
    got = K.banded_flash_attention(*args, lengths)
    assert K.banded_flash_attention.launches == before + K.fwd_launches(dtype)
    ref = K.banded_flash_attention_plain(*args, lengths)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == dtype
    _close(got, ref, dtype)


BASE_SPECS = ((3, 2),) * 4 + ((2, 2),) * 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,channels,specs", [
    (2, 333, (32,) * 7, BASE_SPECS),
    (2, 1000, (512,) * 7, BASE_SPECS),
    (3, 261, (64, 64), ((3, 2),)),                 # T_out 130: M not a multiple of 128
    (2, 700, (64, 72, 72), ((3, 2), (2, 2))),      # Cout 72: N and K tails of the tiles
    (2, 4000, (32, 32, 64), ((8, 4), (4, 4))),     # the tiny preset's layers 1-2
], ids=["c32", "c512", "m-tail", "cout72", "tiny"])
def test_conv_stack_kernel_matches_twin(card, dtype, B, T, channels, specs):
    """One launch per layer against the twin; bf16 runs the wgmma/TMA
    kernel, f32 the CUDA-core kernel."""
    g = torch.Generator().manual_seed(T + channels[-1])
    x = torch.randn(B, T, channels[0], generator=g).to(dtype).to(card)
    ws = [(torch.randn(k, ci, co, generator=g) / (k * ci) ** 0.5).to(dtype).to(card)
          for (k, _), ci, co in zip(specs, channels, channels[1:])]
    before = K.conv_stack.launches
    got = K.conv_stack(x, ws, specs)
    assert K.conv_stack.launches == before + len(specs)
    ref = K.conv_stack_plain(x, ws, specs)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_stack_kernel_takes_more_rows_than_the_old_grid_cap(card, dtype):
    """B 16 x T_out 262,200 = 4,195,200 output rows, past the 65535 x 64
    rows that the first design's grid.y could hold: the row tiles run along
    grid.x."""
    g = torch.Generator().manual_seed(16)
    x = torch.randn(16, 2 * 262_200, 8, generator=g).to(dtype).to(card)
    w = (torch.randn(2, 8, 16, generator=g) / 4).to(dtype).to(card)
    got = K.conv_stack(x, [w], ((2, 2),))
    ref = K.conv_stack_plain(x, [w], ((2, 2),))
    torch.cuda.synchronize()
    assert got.shape == (16, 262_200, 16)
    _close(got, ref, dtype)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    q = torch.zeros(2, 8, 4, device=card)
    band = torch.zeros(4, 8, 8, device=card)
    with pytest.raises(TypeError):
        K.banded_flash_attention(q.half(), q.half(), q.half(), band.half())
    with pytest.raises(ValueError):
        K.banded_flash_attention(q, q, q, band.cpu())
    with pytest.raises(ValueError):
        K.banded_flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                                 q, q, band)
    # the bf16 conv kernel's TMA strides need Cin and Cout multiples of 8
    x = torch.zeros(1, 100, 12, dtype=torch.bfloat16, device=card)
    before = K.conv_stack.launches
    with pytest.raises(ValueError, match="Cin=12"):
        K.conv_stack(x, [torch.zeros(3, 12, 16, dtype=torch.bfloat16, device=card)], ((3, 2),))
    with pytest.raises(ValueError, match="Cout=12"):
        K.conv_stack(x[..., :8], [torch.zeros(3, 8, 16, dtype=torch.bfloat16, device=card),
                                  torch.zeros(2, 16, 12, dtype=torch.bfloat16, device=card)],
                     ((3, 2), (2, 2)))
    assert K.conv_stack.launches == before


def _train_case(card, dtype, T, Dh, N=6, padded=False):
    """Seeded train-attention inputs on the card, ragged lengths with rows of
    length 0 and 1; the band contiguous or row-padded."""
    g = torch.Generator().manual_seed(T + Dh)
    M = 16
    q, k, v, do = (torch.randn(N, T, Dh, generator=g) * s
                   for s in (Dh ** -0.5, 1, 1, 1))
    table = torch.randn(2 * M, Dh, generator=g) * 0.2
    q, k, v, do = [t.to(dtype).to(card) for t in (q, k, v, do)]
    return q, k, v, do, _band(table, T, M, dtype, card, padded), _lengths(N, T, card)


# launches of one standalone call of each train wrapper: bf16 runs the
# wgmma forward (bias pass, main loop) and backward (dq/dband: bias pass,
# main loop, band pass; dk/dv: bias pass, main loop), f32 the CUDA-core
# kernels (one launch each)
STANDALONE_LAUNCHES = {
    torch.float32: {"banded_attention_train_fwd": 1, "banded_attention_train_bwd_dq": 1,
                    "banded_attention_train_bwd_dkv": 1},
    torch.bfloat16: {"banded_attention_train_fwd": 2, "banded_attention_train_bwd_dq": 3,
                     "banded_attention_train_bwd_dkv": 2},
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T,Dh,N,padded", [
    (77, 16, 6, False), (300, 64, 6, False), (799, 64, 12, False),
    (130, 32, 200, False),     # four blocks of n, one partial
    (199, 64, 6, True),        # the 4 s bucket, the band as the encoder gives it
])
def test_train_kernels_match_twins(card, dtype, rate, T, Dh, N, padded):
    """Forward, dq/dband and dk/dv kernels against their twins, ragged
    lengths with rows of length 0 and 1, each launch counted (bf16 on the
    wgmma kernels, f32 on the CUDA-core ones)."""
    q, k, v, do, band, lengths = _train_case(card, dtype, T, Dh, N, padded)
    seed = 77
    before = K.launch_counts()
    o, stats = K.banded_attention_train_fwd(q, k, v, band, lengths, rate, seed)
    o_ref, stats_ref = K.banded_attention_train_fwd_plain(q, k, v, band, lengths,
                                                          rate, seed)
    args = (q, k, v, band, lengths, o_ref, do, stats_ref, rate, seed)
    got = (o, *K.banded_attention_train_bwd_dq(*args),
           *K.banded_attention_train_bwd_dkv(*args))
    ref = (o_ref, *K.banded_attention_train_bwd_dq_plain(*args),
           *K.banded_attention_train_bwd_dkv_plain(*args))
    torch.cuda.synchronize()
    after = K.launch_counts()
    for name, n in STANDALONE_LAUNCHES[dtype].items():
        assert after[name] == before[name] + n, name
    assert got[2].dtype == torch.float32       # dband accumulates in f32
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, dtype)


def test_bf16_train_backward_is_bit_equal_across_calls(card):
    """dband sums over n inside wgmma's K loop and nothing uses float
    atomics, so two calls give the same bits."""
    q, k, v, do, band, lengths = _train_case(card, torch.bfloat16, 799, 64, 12)
    o, stats = K.banded_attention_train_fwd(q, k, v, band, lengths, 0.1, 5)
    args = (q, k, v, band, lengths, o, do, stats, 0.1, 5)
    first = (*K.banded_attention_train_bwd_dq(*args), *K.banded_attention_train_bwd_dkv(*args))
    second = (*K.banded_attention_train_bwd_dq(*args), *K.banded_attention_train_bwd_dkv(*args))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dband", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_bf16_train_autograd_shares_one_bias_pass(card):
    """The autograd function's bf16 backward runs the bias pass once for
    both wrappers (K.train_launches_per_layer) and gives the standalone
    wrappers' gradients bit for bit."""
    q, k, v, do, band, lengths = _train_case(card, torch.bfloat16, 300, 64)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, band)]
    before = K.launch_counts()
    out = K.banded_attention_train(*leaves, lengths, dropout_rate=0.1, seed=9)
    out.backward(do)
    torch.cuda.synchronize()
    after = K.launch_counts()
    for name, n in K.train_launches_per_layer(torch.bfloat16).items():
        assert after[name] == before[name] + n, name
    o, stats = K.banded_attention_train_fwd(q, k, v, band, lengths, 0.1, 9)
    args = (q, k, v, band, lengths, o, do, stats, 0.1, 9)
    dq, dband = K.banded_attention_train_bwd_dq(*args)
    dk, dv = K.banded_attention_train_bwd_dkv(*args)
    for leaf, want in zip(leaves, (dq, dk, dv, dband.to(torch.bfloat16))):
        assert torch.equal(leaf.grad, want)


def test_bf16_train_backward_raises_for_dh_it_does_not_take(card):
    """Dh 24 is not a multiple of 16: the bf16 backward raises before any
    launch; the f32 route still takes it on the CUDA-core kernels."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, band, lengths = _train_case(card, dtype, 40, 24)
        o, stats = K.banded_attention_train_fwd_plain(q, k, v, band, lengths, 0.0, 0)
        args = (q, k, v, band, lengths, o, do, stats, 0.0, 0)
        before = K.launch_counts()
        if dtype == torch.bfloat16:
            for fn in (K.banded_attention_train_bwd_dq, K.banded_attention_train_bwd_dkv):
                with pytest.raises(ValueError, match="Dh a multiple of 16"):
                    fn(*args)
            assert K.launch_counts() == before
        else:
            got = (*K.banded_attention_train_bwd_dq(*args),
                   *K.banded_attention_train_bwd_dkv(*args))
            ref = (*K.banded_attention_train_bwd_dq_plain(*args),
                   *K.banded_attention_train_bwd_dkv_plain(*args))
            torch.cuda.synchronize()
            after = K.launch_counts()
            for name in ("banded_attention_train_bwd_dq", "banded_attention_train_bwd_dkv"):
                assert after[name] == before[name] + 1, name
            for a, b in zip(got, ref):
                _close(a, b, dtype)


@pytest.mark.parametrize("T,Dh,N", [(77, 16, 6), (799, 64, 12), (130, 32, 200)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_train_forward_stats_match_twin(card, T, Dh, N, rate):
    """The wgmma forward's row statistics (max, sum) against the twin's,
    rows of length 0 (m = -1e9, l = T) and 1 included."""
    q, k, v, _, band, lengths = _train_case(card, torch.bfloat16, T, Dh, N, padded=True)
    _, stats = K.banded_attention_train_fwd(q, k, v, band, lengths, rate, 3)
    _, ref = K.banded_attention_train_fwd_plain(q, k, v, band, lengths, rate, 3)
    torch.cuda.synchronize()
    assert stats.shape == ref.shape == (2, N, T) and stats.dtype == torch.float32
    torch.testing.assert_close(stats, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T,Dh,N,padded", [(77, 16, 6, False), (799, 64, 12, True),
                                           (130, 32, 200, True)])
def test_bf16_forward_scores_are_the_backwards_bits(card, T, Dh, N, padded):
    """The forwards' bias pass and the backward's compute the score's band
    term with one code: the same bits (and the same Q.K^T wgmma tiles), so
    the backward recomputes the forward's scores exactly."""
    q, k, v, do, band, lengths = _train_case(card, torch.bfloat16, T, Dh, N, padded)
    fwd = K.fwd_bias(q, band, K.banded_attention_train_fwd)
    _, bwd, _ = K.train_bwd_bias(q, band, v, do, K.banded_attention_train_bwd_dq)
    torch.cuda.synchronize()
    assert fwd.shape == bwd.shape == (N, T, -(-T // 8) * 8)
    assert torch.equal(fwd, bwd)


def test_bf16_forwards_are_bit_equal_across_calls(card):
    """No float atomics in either forward: two calls give the same bits."""
    q, k, v, _, band, lengths = _train_case(card, torch.bfloat16, 799, 64, 12, padded=True)
    first = (K.banded_flash_attention(q, k, v, band, lengths),
             *K.banded_attention_train_fwd(q, k, v, band, lengths, 0.1, 5))
    second = (K.banded_flash_attention(q, k, v, band, lengths),
              *K.banded_attention_train_fwd(q, k, v, band, lengths, 0.1, 5))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "train out", "stats"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_train_autograd_through_row_padded_band_matches_twins(card, rate):
    """Forward and backward through ``banded_attention_train`` at bf16 with
    the band as a row-padded view of a leaf: out, dq, dk, dv and the band's
    gradient against the twin forward and the twin backward; the padding
    columns get no gradient."""
    N, T, Dh, M = 12, 199, 64, 16
    q, k, v, do, _, lengths = _train_case(card, torch.bfloat16, T, Dh, N)
    g = torch.Generator().manual_seed(11)
    table = (torch.randn(2 * M, Dh, generator=g) * 0.2).to(card)
    storage = torch.zeros(Dh, T, 200, dtype=torch.bfloat16, device=card)
    storage[..., :T] = band_from_table(table, T, M, dtype=torch.bfloat16)
    band = storage.requires_grad_()[..., :T]        # strides (T * 200, 200, 1)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = K.launch_counts()
    out = K.banded_attention_train(*leaves, band, lengths, dropout_rate=rate, seed=21)
    out.backward(do)
    torch.cuda.synchronize()
    after = K.launch_counts()
    for name, n in K.train_launches_per_layer(torch.bfloat16).items():
        assert after[name] == before[name] + n, name
    bd = band.detach()
    o_ref, stats_ref = K.banded_attention_train_fwd_plain(q, k, v, bd, lengths, rate, 21)
    args = (q, k, v, bd, lengths, o_ref, do, stats_ref, rate, 21)
    dq, dband = K.banded_attention_train_bwd_dq_plain(*args)
    dk, dv = K.banded_attention_train_bwd_dkv_plain(*args)
    for got, ref in zip((out, *(t.grad for t in leaves), storage.grad[..., :T]),
                        (o_ref, dq, dk, dv, dband)):
        _close(got, ref, torch.bfloat16)
    assert not storage.grad[..., T:].any()


def test_bf16_forwards_raise_before_any_launch(card):
    """Dh 24 (not a multiple of 16) and a band of any stride but the two
    layouts: both forwards raise before any launch."""
    q, k, v, _, band, lengths = _train_case(card, torch.bfloat16, 40, 24)
    before = K.launch_counts()
    with pytest.raises(ValueError, match="Dh a multiple of 16"):
        K.banded_flash_attention(q, k, v, band, lengths)
    with pytest.raises(ValueError, match="Dh a multiple of 16"):
        K.banded_attention_train_fwd(q, k, v, band, lengths, 0.0, 0)
    q, k, v, _, band, lengths = _train_case(card, torch.bfloat16, 40, 32)
    wide = torch.zeros(32, 40, 56, dtype=torch.bfloat16, device=card)
    wide[..., :40] = band
    for bad in (band.transpose(1, 2), wide[..., :40]):
        with pytest.raises(ValueError, match="strides"):
            K.banded_flash_attention(q, k, v, bad, lengths)
        with pytest.raises(ValueError, match="strides"):
            K.banded_attention_train_fwd(q, k, v, bad, lengths, 0.0, 0)
    assert K.launch_counts() == before


def test_inference_kernel_raises_under_grad(card):
    q = torch.randn(2, 8, 4, device=card, requires_grad=True)
    band = torch.zeros(4, 8, 8, device=card)
    before = K.banded_flash_attention.launches
    with pytest.raises(RuntimeError, match="inference-only"):
        K.banded_flash_attention(q, q.detach(), q.detach(), band)
    assert K.banded_flash_attention.launches == before


def test_conv_stack_gradient_is_the_twin_vjp(card):
    g = torch.Generator().manual_seed(5)
    specs = ((3, 2),) * 2 + ((2, 2),)
    x = torch.randn(2, 301, 64, generator=g)
    ws = [torch.randn(k, 64, 64, generator=g) / (k * 64) ** 0.5 for k, _ in specs]
    leaves = [t.to(card).requires_grad_() for t in (x, *ws)]
    refs = [t.to(card).requires_grad_() for t in (x, *ws)]
    before = K.conv_stack.launches
    y = K.conv_stack(leaves[0], leaves[1:], specs)
    assert K.conv_stack.launches == before + len(specs)
    cot = torch.randn(y.shape, generator=g).to(card)
    y.backward(cot)
    K.conv_stack_plain(refs[0], refs[1:], specs).backward(cot)
    for a, b in zip(leaves, refs):
        _close(a.grad, b.grad, torch.float32)


@pytest.mark.parametrize("B,T,n_fft,hop,n_mels,center", [
    (2, 16000, 512, 128, 24, True),        # tests/test_pallas_kernels.py:15
    (1, 5000, 512, 128, 24, True),         # frames not a multiple of the tile
    (3, 767 * 256 + 1024, 1024, 256, 80, False),   # the t2s step's rows
    (2, 4000, 1024, 256, 128, False),      # the most mels the kernel takes
    (2, 3001, 256, 64, 40, True),          # the smallest FFT; rows not 16-byte aligned
    (1, 9000, 2048, 512, 80, True),        # the largest: 64 values a lane
])
def test_log_mel_kernel_matches_twin(card, B, T, n_fft, hop, n_mels, center):
    """One launch against the twin (f32, TF32 off), atol 2e-3 on log10-mel
    (the JAX spec's, tests/test_pallas_kernels.py:23); a zero tail gives the
    floor exactly."""
    g = torch.Generator().manual_seed(T + n_mels)
    wav = torch.randn(B, T, generator=g) * 0.2
    wav[-1, T // 2:] = 0.0
    wav = wav.to(card)
    kw = dict(n_fft=n_fft, hop=hop, n_mels=n_mels, center=center)
    before = K.fused_log_mel.launches
    got = K.fused_log_mel(wav, **kw)
    assert K.fused_log_mel.launches == before + 1
    ref = K.fused_log_mel_plain(wav, **kw)
    torch.cuda.synchronize()
    frames = 1 + (T // hop if center else (T - n_fft) // hop)
    assert got.shape == ref.shape == (B, frames, n_mels) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 2e-3
    assert (got[-1, -2:] == -10.0).all()


def test_log_mel_wrapper_rejects_what_the_kernel_does_not_take(card):
    wav = torch.zeros(2, 8000, device=card)
    before = K.fused_log_mel.launches
    with pytest.raises(TypeError):
        K.fused_log_mel(wav.double())
    with pytest.raises(ValueError):
        K.fused_log_mel(torch.zeros(8000, 2, device=card).t())      # strided
    with pytest.raises(ValueError):
        K.fused_log_mel(wav, n_fft=1024, hop=384)                   # hop does not divide
    with pytest.raises(ValueError):
        K.fused_log_mel(wav, n_fft=768, hop=256)                    # not a power of two
    with pytest.raises(ValueError):
        K.fused_log_mel(wav, n_fft=4096, hop=256)                   # past the largest FFT
    with pytest.raises(ValueError):
        K.fused_log_mel(wav, n_mels=129)
    with pytest.raises(ValueError):
        K.fused_log_mel(wav[:, :1000], center=False)                # shorter than n_fft
    with pytest.raises(ValueError):
        K.fused_log_mel(wav[0])                                     # not [B, T]
    assert K.fused_log_mel.launches == before


def _flash_case(N, Tq, Tk, D, seed, bias=True, lengths=None):
    """q (scaled), k, v, an f32 bias or None, and a prefix key mask from
    ``lengths`` (a row of length 0 has no valid key) or None."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(N, Tq, D, generator=g) * D ** -0.5
    k, v = torch.randn(N, Tk, D, generator=g), torch.randn(N, Tk, D, generator=g)
    b = torch.randn(N, Tq, Tk, generator=g) * 0.5 if bias else None
    valid = None
    if lengths is not None:
        valid = torch.arange(Tk)[None, :] < torch.tensor(lengths)[:, None]
    return q, k, v, b, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Tq,Tk,D,bias,lengths", [
    (3, 64, 64, 32, True, [64, 40, 64]),          # tests/test_pallas_kernels.py:114
    (4, 48, 48, 16, True, None),                  # :131, the rel-pos bias case
    (2, 37, 53, 16, False, [30, 53]),             # :149, tails of Tq and Tk
    (12, 5, 799, 64, False, [799] * 6 + [613] * 6),   # grouped cross, a 16 s chunk
    (60, 1, 201, 64, False, [101] * 30 + [1] * 30),   # cached self-attention step
    (2, 9, 1500, 128, True, [1500, 0]),           # long keys, D 128, no valid key
    (4, 3, 40, 64, True, [40, 17, 1, 0]),         # Tk under one tile
    (6, 2, 1, 64, False, [1, 1, 1, 0, 1, 1]),     # Tk = 1
    (12, 5, 799, 64, False, [100] * 12),          # blocks 2-7 hold only invalid keys
    (3, 17, 2000, 32, True, [2000, 1000, 5]),     # 32 tiles: four a block, Tq > 8
    # cluster sizes 1-8: ceil(Tk / 64) tiles, tails of Tk and Tq
    *[(5, 5, 64 * c - 13, 64, False, [64 * c - 13, 64 * c - 70, 3, 0, 64 * c - 13])
      for c in range(2, 9)],
])
def test_flash_bias_kernel_matches_twin(card, dtype, N, Tq, Tk, D, bias, lengths):
    """One launch against the dense twin: f32 1e-4 (sums in another order),
    bf16 3e-2 x max|ref| (each block of the cluster rounds its running
    probabilities to bf16, the twin the normalised ones); a second call
    gives the same bits (the cluster combines in a fixed order)."""
    q, k, v, b, valid = _flash_case(N, Tq, Tk, D, seed=N + Tk, bias=bias,
                                    lengths=lengths)
    q, k, v = (t.to(dtype).to(card) for t in (q, k, v))
    b = None if b is None else b.to(card)
    valid = None if valid is None else valid.to(card)
    before = K.flash_attention_bias.launches
    got = K.flash_attention_bias(q, k, v, b, valid)
    assert K.flash_attention_bias.launches == before + 1
    ref = K.flash_attention_bias_plain(q, k, v, b, valid)
    torch.cuda.synchronize()
    assert got.shape == (N, Tq, D) and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    _close(got, ref, dtype)
    assert torch.equal(got, K.flash_attention_bias(q, k, v, b, valid))
    if lengths is not None and 0 in lengths:   # the dense formula: mean of V
        n = lengths.index(0)
        _close(got[n], v[n].float().mean(0).expand(Tq, D), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bias_kernel_shares_mask_rows_and_skips_masked_tiles(card, dtype):
    """The decode path's mask, one row per 12 heads ([5, 201] for 60 rows):
    bit-equal to the same launch with the mask expanded to [60, 201], and
    close to the twin.  Tiles past a row's last valid key are skipped, so
    NaN K and V there change no bit; one row's first tile has no valid key
    (keys 70..99)."""
    N, H, Tk, D = 60, 12, 201, 64
    starts, ends = [0, 0, 0, 0, 70], [101, 1, 64, 201, 100]
    q, k, v, _, _ = _flash_case(N, 1, Tk, D, seed=7, bias=False)
    pos = torch.arange(Tk)[None, :]
    mask = (pos >= torch.tensor(starts)[:, None]) & (pos < torch.tensor(ends)[:, None])
    q, k, v, mask = (t.to(card) for t in (q.to(dtype), k.to(dtype), v.to(dtype), mask))
    got = K.flash_attention_bias(q, k, v, None, mask)
    full = mask.repeat_interleave(H, 0)
    assert torch.equal(got, K.flash_attention_bias(q, k, v, None, full))
    _close(got, K.flash_attention_bias_plain(q, k, v, None, mask), dtype)
    k_nan, v_nan = k.clone(), v.clone()
    for b, e in enumerate(ends):
        rows = slice(b * H, (b + 1) * H)
        k_nan[rows, -(-e // 64) * 64:] = float("nan")
        v_nan[rows, -(-e // 64) * 64:] = float("nan")
    assert torch.equal(got, K.flash_attention_bias(q, k_nan, v_nan, None, mask))


def test_flash_bias_wrapper_rejects_what_the_kernel_does_not_take(card):
    q = torch.zeros(2, 3, 16, device=card)
    k = torch.zeros(2, 7, 16, device=card)
    before = K.flash_attention_bias.launches
    with pytest.raises(TypeError):
        K.flash_attention_bias(q, k, k, torch.zeros(2, 3, 7, device=card).half())
    with pytest.raises(TypeError):
        K.flash_attention_bias(q, k, k, None, torch.ones(2, 7, device=card))
    with pytest.raises(TypeError):   # mask rows must divide the rows
        K.flash_attention_bias(q, k, k, None, torch.ones(3, 7, device=card).bool())
    with pytest.raises(ValueError):
        K.flash_attention_bias(q, k.transpose(0, 1).contiguous().transpose(0, 1), k)
    with pytest.raises(ValueError):
        K.flash_attention_bias(torch.zeros(2, 3, 160, device=card),
                               torch.zeros(2, 7, 160, device=card),
                               torch.zeros(2, 7, 160, device=card))
    with pytest.raises(RuntimeError, match="forward-only"):
        K.flash_attention_bias(q.requires_grad_(), k, k)
    assert K.flash_attention_bias.launches == before


@pytest.mark.parametrize("N,Tq,Tk,D,lengths", [
    (12, 499, 499, 64, [499]),            # WavLM Base, 10 s (mask [1, T])
    (12, 1499, 1499, 64, [1499]),         # 30 s
    (24, 1499, 1499, 64, [1499, 1000]),   # the padded batch of two: 8 tiles skipped
    (12, 77, 77, 64, [77]),               # T a multiple of neither 8 nor 64
    (12, 200, 1499, 64, [1499]),          # Tq != Tk
    (24, 130, 130, 64, [130, 0]),         # a sample with no valid key
    *[(6, 150, 333, D, [333, 100]) for D in (16, 32, 48, 64)],
])
def test_flash_bias_tiled_kernel_matches_twin(card, N, Tq, Tk, D, lengths):
    """The query-tiled kernel (bf16, long queries): one launch of the tiled
    path against the dense twin within 3e-2 x max|ref| (bf16 probabilities
    at the running max, the twin's at the final one), the same bits on a
    second call; a sample with no valid key returns the mean of V over its
    Tk keys."""
    assert K.flash_bias_path(Tq, Tk, D, torch.bfloat16) == "tiled"
    q, k, v, b, _ = _flash_case(N, Tq, Tk, D, seed=N + Tq + D)
    q, k, v = (t.to(torch.bfloat16).to(card) for t in (q, k, v))
    b = b.to(card)
    valid = (torch.arange(Tk)[None, :] < torch.tensor(lengths)[:, None]).to(card)
    before = K.launch_counts()
    got = K.flash_attention_bias(q, k, v, b, valid)
    after = K.launch_counts()
    assert after["flash_attention_bias"] == before["flash_attention_bias"] + 1
    assert after["flash_attention_bias_tiled"] == before["flash_attention_bias_tiled"] + 1
    ref = K.flash_attention_bias_plain(q, k, v, b, valid)
    torch.cuda.synchronize()
    assert got.shape == (N, Tq, D) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    _close(got, ref, torch.bfloat16)
    assert torch.equal(got, K.flash_attention_bias(q, k, v, b, valid))
    R = N // len(lengths)
    for s, n_valid in enumerate(lengths):
        if n_valid == 0:
            rows = slice(s * R, (s + 1) * R)
            _close(got[rows], v[rows].float().mean(1, keepdim=True).expand(-1, Tq, -1),
                   torch.bfloat16)


def test_flash_bias_tiled_kernel_takes_any_mask_pattern(card):
    """A mask that is no prefix (row 0's first 70 keys invalid, so its first
    tile is skipped; row 1 one valid key) and a zero bias given as None:
    against the twin, and bit-equal to the same launch with the mask
    expanded to one row per head."""
    N, Tq, Tk, D = 8, 100, 300, 64
    q, k, v, _, _ = _flash_case(N, Tq, Tk, D, seed=5, bias=False)
    q, k, v = (t.to(torch.bfloat16).to(card) for t in (q, k, v))
    valid = torch.ones(4, Tk, dtype=torch.bool)
    valid[0, :70] = False
    valid[1] = False
    valid[1, 257] = True
    valid[2, ::3] = False
    valid = valid.to(card)
    got = K.flash_attention_bias(q, k, v, None, valid)
    _close(got, K.flash_attention_bias_plain(q, k, v, None, valid), torch.bfloat16)
    full = valid.repeat_interleave(2, 0)
    assert torch.equal(got, K.flash_attention_bias(q, k, v, None, full))


@pytest.mark.parametrize("rows,maxp", [(True, False), (False, True)])
def test_flash_bias_cached_entry_keeps_the_split_kernel_at_long_queries(card, rows, maxp):
    """The cached entry at WavLM's long queries (q4 [2, 499, 12, 64]) with an
    ancestry row map or the max-probability output: one launch of the split
    kernel (none of the tiled one), against its twin."""
    g = torch.Generator().manual_seed(3)
    B, T, H, D = 2, 499, 12, 64
    q4 = (torch.randn(B, T, H, D, generator=g) * D ** -0.5).bfloat16().to(card)
    k4, v4 = (torch.randn(B, T, H, D, generator=g).bfloat16().to(card) for _ in range(2))
    valid = (torch.arange(T)[None, :] < torch.tensor([[T], [300]])).to(card)
    row_map = torch.tensor([[1], [0]]).expand(B, T).contiguous().to(card) if rows else None
    before = K.launch_counts()
    got = K.flash_attention_bias_cached(q4, k4, v4, valid, row_map, return_max_prob=maxp)
    after = K.launch_counts()
    assert after["flash_attention_bias"] == before["flash_attention_bias"] + 1
    assert after["flash_attention_bias_tiled"] == before["flash_attention_bias_tiled"]
    ref = K.flash_attention_bias_cached_plain(q4, k4, v4, valid, row_map, return_max_prob=maxp)
    torch.cuda.synchronize()
    _close(got[0] if maxp else got, ref[0] if maxp else ref, torch.bfloat16)


def test_flash_bias_tiled_path_raises_on_what_it_does_not_take(card):
    """A misaligned q on the tiled path: the kernel refuses it and the
    wrapper raises, launching nothing (no fallback to the split kernel or
    the twin); D 40 and D 160 at long queries are refused before any
    launch, as on the split path."""
    N, T, D = 2, 96, 64
    q = torch.zeros(N * T * D + 1, dtype=torch.bfloat16, device=card)[1:].view(N, T, D)
    k = torch.zeros(N, T, D, dtype=torch.bfloat16, device=card)
    assert q.is_contiguous() and q.data_ptr() % 16
    before = K.launch_counts()
    with pytest.raises(RuntimeError, match="tiled"):
        K.flash_attention_bias(q, k, k)
    for d in (40, 160):
        x = torch.zeros(N, T, d, dtype=torch.bfloat16, device=card)
        with pytest.raises(ValueError):
            K.flash_attention_bias(x, x, x)
    assert K.launch_counts() == before


def _cached_case(case, dtype, card, seed=9):
    """The beam's step layouts at Base width: "self", q [5, 1, 12, 64]
    against the cache [5, 201, 12, 64] through an ancestry map (rows
    repeated and permuted) with the causal [1, 201] mask of position 100;
    "cross", 5 grouped queries [1, 5, 12, 64] against head-major K/V
    [1, 12, 799, 64] viewed as [1, 799, 12, 64], 549 valid frames."""
    g = torch.Generator().manual_seed(seed)
    if case == "self":
        B, Tq, Tk = 5, 1, 201
        k4, v4 = (torch.randn(B, Tk, 12, 64, generator=g) for _ in range(2))
        rows = torch.randint(0, B, (B, Tk), generator=g)
        rows[:, 0] = torch.randperm(B, generator=g)
        rows[1] = rows[0]
        valid = torch.arange(Tk)[None, :] <= 100
    else:
        B, Tq, Tk = 1, 5, 799
        k4, v4 = (torch.randn(B, 12, Tk, 64, generator=g).transpose(1, 2) for _ in range(2))
        rows = None
        valid = torch.arange(Tk)[None, :] < 549
    q4 = torch.randn(B, Tq, 12, 64, generator=g) * 64 ** -0.5
    out = [t.to(dtype).to(card) for t in (q4, k4, v4)]
    return (*out, valid.to(card), None if rows is None else rows.to(card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["self", "cross"])
def test_flash_bias_cached_kernel_matches_twin(card, dtype, case):
    """The cached entry reads the cache and the head-major cross K/V in
    place (one launch) and agrees with its twin (gather, then the dense
    formula); two calls give the same bits; K/V that no valid key reads
    may hold NaN."""
    q4, k4, v4, valid, rows = _cached_case(case, dtype, card)
    before = K.flash_attention_bias.launches
    got = K.flash_attention_bias_cached(q4, k4, v4, valid, rows)
    assert K.flash_attention_bias.launches == before + 1
    ref = K.flash_attention_bias_cached_plain(q4, k4, v4, valid, rows)
    torch.cuda.synchronize()
    assert got.shape == q4.shape and got.dtype == dtype and got.is_contiguous()
    _close(got, ref, dtype)
    assert torch.equal(got, K.flash_attention_bias_cached(q4, k4, v4, valid, rows))
    # only valid keys are read: NaN in every invalid position (and, through
    # the row map, in every cache row that no valid key reads) changes no bit
    k_nan, v_nan = k4.clone(), v4.clone()
    invalid = ~valid[0]
    k_nan[:, invalid], v_nan[:, invalid] = float("nan"), float("nan")
    if rows is not None:
        unread = torch.ones(k4.shape[0], dtype=torch.bool, device=card)
        unread[rows[:, valid[0]].flatten()] = False
        k_nan[unread], v_nan[unread] = float("nan"), float("nan")
    assert torch.equal(got, K.flash_attention_bias_cached(q4, k_nan, v_nan, valid, rows))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [48, 80, 112])
@pytest.mark.parametrize("N,Tq,Tk,lengths", [
    (4, 5, 799, [799, 613, 0, 1]),                 # grouped queries, long keys
    (80, 1, 201, [101] * 40 + [1] * 39 + [0]),     # the fusion LM's step: 5 x 16 heads
])
def test_flash_bias_kernel_takes_head_sizes_multiple_of_16(card, dtype, D, N, Tq, Tk,
                                                           lengths):
    """D a multiple of 16 that is no power of two (80: the fusion LM's head
    size; a key row of 6, 10 or 14 bf16 vectors, 12, 20 or 28 f32 ones):
    one launch against the dense twin, rows with no valid key (the mean of
    V) kept, the same bits on a second call; D 40 is refused."""
    q, k, v, b, valid = _flash_case(N, Tq, Tk, D, seed=D + N, bias=True, lengths=lengths)
    q, k, v = (t.to(dtype).to(card) for t in (q, k, v))
    b, valid = b.to(card), valid.to(card)
    before = K.flash_attention_bias.launches
    got = K.flash_attention_bias(q, k, v, b, valid)
    assert K.flash_attention_bias.launches == before + 1
    ref = K.flash_attention_bias_plain(q, k, v, b, valid)
    torch.cuda.synchronize()
    assert got.shape == (N, Tq, D) and torch.isfinite(got.float()).all()
    _close(got, ref, dtype)
    assert torch.equal(got, K.flash_attention_bias(q, k, v, b, valid))
    n = lengths.index(0)
    _close(got[n], v[n].float().mean(0).expand(Tq, D), dtype)
    with pytest.raises(ValueError):
        K.flash_attention_bias(q[..., :40], k[..., :40].contiguous(),
                               v[..., :40].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [48, 80, 112])
def test_flash_bias_cached_kernel_takes_head_sizes_multiple_of_16(card, dtype, D):
    """The cached entry as the fusion LM's decode step calls it: q [5, 1,
    16, D] against the cache [5, 201, 16, D] through an int64 ancestry map
    (rows repeated and permuted), a per-row mask [80, 201] of the causal
    limit at position 100 with one row of no valid key: against the twin,
    the same bits twice, unread cache rows free to hold NaN."""
    g = torch.Generator().manual_seed(D)
    B, H, Tk = 5, 16, 201
    k4, v4 = (torch.randn(B, Tk, H, D, generator=g) for _ in range(2))
    q4 = torch.randn(B, 1, H, D, generator=g) * D ** -0.5
    rows = torch.randint(0, B, (B, Tk), generator=g)
    rows[:, 0] = torch.randperm(B, generator=g)
    valid = (torch.arange(Tk)[None, :] <= 100).expand(B * H, Tk).clone()
    valid[7] = False
    q4, k4, v4 = (t.to(dtype).to(card) for t in (q4, k4, v4))
    valid, rows = valid.to(card), rows.to(card)
    before = K.flash_attention_bias.launches
    got = K.flash_attention_bias_cached(q4, k4, v4, valid, rows)
    assert K.flash_attention_bias.launches == before + 1
    ref = K.flash_attention_bias_cached_plain(q4, k4, v4, valid, rows)
    torch.cuda.synchronize()
    assert got.shape == q4.shape and got.is_contiguous()
    _close(got, ref, dtype)
    assert torch.equal(got, K.flash_attention_bias_cached(q4, k4, v4, valid, rows))
    # with every row holding a valid key, only valid keys are read
    valid[7] = valid[6]
    got = K.flash_attention_bias_cached(q4, k4, v4, valid, rows)
    k_nan, v_nan = k4.clone(), v4.clone()
    k_nan[:, 101:], v_nan[:, 101:] = float("nan"), float("nan")
    unread = torch.ones(B, dtype=torch.bool, device=card)
    unread[rows[:, :101].flatten()] = False
    k_nan[unread], v_nan[unread] = float("nan"), float("nan")
    assert torch.equal(got, K.flash_attention_bias_cached(q4, k_nan, v_nan, valid, rows))


def test_flash_bias_cached_wrapper_refuses_what_the_kernel_does_not_take(card):
    q4, k4, v4, valid, rows = _cached_case("self", torch.bfloat16, card)
    before = K.flash_attention_bias.launches
    big = torch.zeros(5, 201, 2, 160, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):                  # D > 128
        K.flash_attention_bias_cached(big[:, :1], big, big, valid, rows)
    with pytest.raises(ValueError):                  # d not contiguous
        K.flash_attention_bias_cached(q4, k4.transpose(2, 3).contiguous().transpose(2, 3),
                                      v4, valid, rows)
    wide = torch.zeros(5, 201, 12, 72, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):                  # rows not 16-byte aligned
        K.flash_attention_bias_cached(q4, wide[..., 1:65], v4, valid, rows)
    with pytest.raises(ValueError):                  # a row map of the wrong shape
        K.flash_attention_bias_cached(q4, k4, v4, valid, rows[:, :100])
    with pytest.raises(ValueError):                  # nor type
        K.flash_attention_bias_cached(q4, k4, v4, valid, rows.int())
    with pytest.raises(ValueError):                  # no row map: one K/V row a sample
        K.flash_attention_bias_cached(q4, k4[:3], v4[:3], valid)
    with pytest.raises(TypeError):                   # mask rows must divide B * H
        K.flash_attention_bias_cached(q4, k4, v4, valid.expand(7, 201).contiguous(), rows)
    assert K.flash_attention_bias.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_kernel_route_matches_plain_route(card, dtype):
    """speecht5_base_asr's decoder width (d 768, 12 heads) with two layers:
    5 steps of ``text_decode_step`` (beam 3 over 2 samples, grouped cross
    attention, a shuffled ancestry map) with decoder.use_pallas_attn on and
    off: the kernel launches twice a layer a step (self and cross), the
    plain route never."""
    from speecht5_tpu_torch import config as C
    from speecht5_tpu_torch.models.speecht5 import init_model

    base = C.replace(C.speecht5_base_asr(dtype="float32" if dtype == torch.float32
                                         else "bfloat16"), vocab_size=81, blank_id=80)
    base = C.apply_overrides(base, ["decoder.num_layers=2", "encoder.num_layers=1"])
    models = [init_model(C.apply_overrides(base, [f"decoder.use_pallas_attn={on}"]),
                         torch.Generator().manual_seed(0), card) for on in (True, False)]
    models[1].load_state_dict(models[0].state_dict())
    g = torch.Generator().manual_seed(1)
    B, K3, Tsrc, steps = 2, 3, 50, 5
    enc = {"encoder_out": torch.randn(B, Tsrc, 768, generator=g).to(card),
           "valid_mask": (torch.arange(Tsrc)[None, :] < torch.tensor([[50], [31]])).to(card)}
    toks = torch.randint(4, 80, (B * K3, steps), generator=g).to(card)
    rows = torch.randint(0, B * K3, (B * K3, steps + 1), generator=g).to(card)
    outs = []
    with torch.inference_mode():
        for m in models:
            cache = m.init_text_cache(enc, B * K3, steps + 1)
            before = K.flash_attention_bias.launches
            logits = []
            for t in range(steps):
                lg, cache = m.text_decode_step(toks[:, t : t + 1], cache,
                                               enc_valid=enc["valid_mask"],
                                               cache_rows=rows)
                logits.append(lg)
            outs.append((torch.stack(logits), K.flash_attention_bias.launches - before))
    torch.cuda.synchronize()
    (got, n_k), (ref, n_p) = outs
    assert n_k == 2 * 2 * steps and n_p == 0
    assert torch.isfinite(got).all()
    _close(got, ref, dtype)


def _tts_case(case, dtype, card, seed=11):
    """The TTS decoder's decode-step shapes at batch 1, 12 heads, Dh 64:
    "tts_self", the cached self-attention at step 200 of a 513-position
    cache (201 valid); "tts_cross", the cross-attention against a 128-token
    text bucket with 37 valid tokens (head-major K/V, as precompute_kv
    lays them out)."""
    g = torch.Generator().manual_seed(seed)
    if case == "tts_self":
        Tk, valid = 513, torch.arange(513)[None, :] <= 200
        k4, v4 = (torch.randn(1, Tk, 12, 64, generator=g) for _ in range(2))
    else:
        Tk, valid = 128, torch.arange(128)[None, :] < 37
        k4, v4 = (torch.randn(1, 12, Tk, 64, generator=g).transpose(1, 2) for _ in range(2))
    q4 = torch.randn(1, 1, 12, 64, generator=g) * 64 ** -0.5
    return (*[t.to(dtype).to(card) for t in (q4, k4, v4)], valid.to(card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["self", "cross", "tts_self", "tts_cross"])
def test_flash_bias_max_prob_matches_twin(card, dtype, case):
    """The optional max-probability output (the focus rate's input) comes
    from the same launch, agrees with the twin's max of the f32 softmax
    (f32 1e-4, bf16 3e-2 of max |ref|), and leaves the attention output's
    bits as they are without it."""
    if case.startswith("tts"):
        q4, k4, v4, valid = _tts_case(case, dtype, card)
        rows = None
    else:
        q4, k4, v4, valid, rows = _cached_case(case, dtype, card)
    before = K.flash_attention_bias.launches
    got, maxp = K.flash_attention_bias_cached(q4, k4, v4, valid, rows,
                                              return_max_prob=True)
    assert K.flash_attention_bias.launches == before + 1
    ref, ref_maxp = K.flash_attention_bias_cached_plain(q4, k4, v4, valid, rows,
                                                        return_max_prob=True)
    torch.cuda.synchronize()
    B, Tq, H, _ = q4.shape
    assert maxp.shape == (B * H, Tq) and maxp.dtype == torch.float32
    _close(maxp, ref_maxp, dtype)
    _close(got, ref, dtype)
    assert torch.equal(got, K.flash_attention_bias_cached(q4, k4, v4, valid, rows))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
def test_pre_ln_encoder_kernel_route_matches_plain_route(card, dtype, train):
    """A Large-shaped pre-LN encoder stack (3 layers, 16 heads of Dh 64,
    each layer's norm_k on the table) at T 133 with ragged lengths: the
    kernel route (each layer's row-padded band into the inference or the
    train kernel) against the plain route (``relative_bias``), the output
    and, training, the table's and norm_k's gradients of a fixed random
    projection of the output (f32 1e-4 of max |ref|; bf16 3e-2).  The sum
    of squares would be a constant after the final LayerNorm.  The norm_k
    biases, whose gradient is analytically 0 (each adds one constant to a
    row of logits), stay within the same share of the largest gradient on
    both routes."""
    from dataclasses import replace

    from speecht5_tpu_torch.config import RelPosConfig, TransformerConfig
    from speecht5_tpu_torch.models.encoder import TransformerEncoder

    cfg = TransformerConfig(d_model=1024, ffn_dim=4096, num_layers=3, num_heads=16,
                            dropout=0.0, attention_dropout=0.0, layer_norm_first=True,
                            rel_pos=RelPosConfig(max_distance=160))
    torch.manual_seed(0)
    plain = TransformerEncoder(cfg, dtype=dtype).to(card).train(train)
    kern = TransformerEncoder(replace(cfg, use_pallas_attn=True, use_pallas_attn_train=True),
                              dtype=dtype).to(card).train(train)
    kern.load_state_dict(plain.state_dict())
    T = 133
    x = torch.randn(2, T, 1024, device=card)
    proj = torch.randn(2, T, 1024, device=card)
    valid = torch.arange(T, device=card)[None, :] < torch.tensor([[T], [71]], device=card)
    outs = []
    K.reset_launch_counts()
    for enc in (kern, plain):
        with torch.set_grad_enabled(train):
            y = enc(x, valid)["encoder_out"]
            if train:
                (y.float() * proj).sum().backward()
        outs.append((y.detach(), {n: p.grad for n, p in enc.named_parameters()
                                  if "norm_k" in n or "pe_k" in n} if train else {}))
    counts = K.launch_counts()
    if train:
        per = K.train_launches_per_layer(dtype)
        assert all(counts[n] == 3 * per[n] for n in per), counts
    else:
        assert counts["banded_flash_attention"] == 3 * K.fwd_launches(dtype), counts
    (yk, gk), (yp, gp) = outs
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert (yk.float() - yp.float()).abs().max() <= tol * yp.float().abs().max()
    gmax = max((g.float().abs().max() for g in gp.values()), default=0.0)
    for n, g in gp.items():
        if n.endswith("norm_k.bias"):
            assert max(gk[n].abs().max(), g.abs().max()) <= tol * gmax, n
        else:
            assert (gk[n] - g).abs().max() <= tol * g.abs().max(), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_stack_backward_recomputes_through_the_library_conv(card, dtype):
    """The conv stack's backward on the card: autograd through
    ``conv_stack_library`` (cuDNN), not the twin: its dx and dw equal that
    function's own autograd within 1e-5 of max |ref| (f32; bf16 1e-2: the
    same recompute, cuDNN's gradient algorithms may differ run to run), and
    the twin's within f32 1e-4 of max |ref| or bf16 3e-2."""
    g = torch.Generator().manual_seed(0)
    specs = ((3, 2), (3, 2), (2, 2))
    x = torch.randn(2, 801, 512, generator=g).to(card, dtype)
    ws = [(torch.randn(k, 512, 512, generator=g) * 512 ** -0.5).to(card, dtype)
          for k, _ in specs]
    grads = []
    for fn in (K.conv_stack, K.conv_stack_library, K.conv_stack_plain):
        leaves = [t.detach().clone().requires_grad_() for t in (x, *ws)]
        y = fn(leaves[0], leaves[1:], specs)
        go = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(y)
        grads.append(torch.autograd.grad(y, leaves, go))
    f32 = dtype == torch.float32
    for a, b, c in zip(*grads):
        assert (a.float() - b.float()).abs().max() <= (1e-5 if f32 else 1e-2) * b.float().abs().max()
        assert (a.float() - c.float()).abs().max() <= (1e-4 if f32 else 3e-2) * c.float().abs().max()


def _family_models(family, dtype, card):
    """The family at Base width with one layer a stack (12 heads of Dh 64,
    the 7-layer conv stack), no dropout, on the kernel route and on the
    plain route with the same weights."""
    from speecht5_tpu_torch.config import apply_overrides, replace
    from speecht5_tpu_torch.models.common import init_weights

    if family == "speech2c":
        from speecht5_tpu_torch.models.speech2c import Speech2CModel as M, speech2c_base as P
        stacks = ("encoder", "decoder")
        flags = ["encoder.use_pallas_attn=True", "encoder.use_pallas_attn_train=True"]
    else:
        if family == "speechlm":
            from speecht5_tpu_torch.models.speechlm import SpeechLMModel as M
            from speecht5_tpu_torch.models.speechlm import SpeechLMConfig as P
            stacks = ("speech_encoder", "unit_encoder")
        else:
            from speecht5_tpu_torch.models.speechut import SpeechUTModel as M
            from speecht5_tpu_torch.models.speechut import SpeechUTConfig as P
            stacks = ("speech_encoder", "unit_encoder", "decoder")
        flags = [f"{s}.{f}=True" for s in ("speech_encoder", "unit_encoder")
                 for f in ("use_pallas_attn", "use_pallas_attn_train")]
    still = [f"{s}.{f}" for s in stacks for f in (
        "num_layers=1", "dropout=0.0", "attention_dropout=0.0", "activation_dropout=0.0")]
    base = apply_overrides(replace(P(), dtype=str(dtype).split(".")[-1]), still)
    models = []
    for ovs in (flags + ["conv_features.impl='pallas'"], []):
        torch.manual_seed(0)
        models.append(init_weights(M(apply_overrides(base, ovs)),
                                   torch.Generator().manual_seed(0)).to(card))
    models[1].load_state_dict(models[0].state_dict())
    return base, models


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["speechlm", "speechut", "speech2c"])
def test_sibling_family_kernel_route_matches_plain_route(card, family, dtype):
    """SpeechLM, SpeechUT and Speech2C at Base width (one layer a stack) on
    2 s and 1.3 s of audio: the kernel route (conv stack, inference and
    train attention) against the plain route with the same weights and
    masks: the unit encoder's (Speech2C: the encoder's) output in eval mode,
    and in train mode the HuBERT logits and the gradients of a fixed random
    projection of them (f32 1e-4 of max |ref|, gradients 1e-3; bf16 3e-2).
    The k_proj biases, whose gradient is analytically 0, stay within that
    share of the largest gradient on both routes."""
    from speecht5_tpu_torch.ops.masking import sample_feature_masks

    cfg, (kern, plain) = _family_models(family, dtype, card)
    g = torch.Generator().manual_seed(1)
    wav = torch.randn(2, 32000, generator=g).to(card) * 0.1
    lens = torch.tensor([32000, 20800], device=card)
    T = cfg.conv_features.out_length(32000)
    fl = cfg.conv_features.out_length(lens.cpu())
    masks = sample_feature_masks(fl, T, cfg.d_model, cfg.masking, g)
    units = torch.randint(0, 504, (2, T), generator=g).to(card)
    mix = torch.zeros(2, T, dtype=torch.bool)
    outs = []
    K.reset_launch_counts()
    for m in (kern, plain):
        with torch.no_grad():
            enc = m.eval().encode_speech(wav, lens) if family != "speechlm" else {
                "encoder_out": m.eval().extract_features(wav, lens)[0]}
        m.train()
        if family == "speechlm":
            logits = m.forward_speech(wav, lens, units, masks=masks, mix_sel=mix)["logits_1"]
        elif family == "speechut":
            logits = m.forward_speech(wav, lens, units, masks=masks, mix_sel=mix)[
                "hubert_logits"]
        else:
            prev = torch.full((2, 5), 2, device=card)
            logits = m.forward_pretrain(wav, lens, prev, masks=masks)["hubert_logits"][0]
        proj = torch.randn(logits.shape, generator=torch.Generator().manual_seed(2)).to(card)
        (logits.float() * proj).sum().backward()
        outs.append((enc["encoder_out"].float(), logits.detach().float(),
                     {n: p.grad.float() for n, p in m.named_parameters()
                      if p.grad is not None}))
    counts = K.launch_counts()
    assert counts["conv_stack"] >= 2 and counts["banded_flash_attention"] > 0, counts
    assert counts["banded_attention_train_fwd"] > 0, counts
    (ek, lk, gk), (ep, lp, gp) = outs
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert (ek - ep).abs().max() <= tol * ep.abs().max()
    assert (lk - lp).abs().max() <= tol * lp.abs().max()
    gtol = 1e-3 if dtype == torch.float32 else 3e-2
    assert set(gk) == set(gp)
    gmax = max(x.abs().max() for x in gp.values())
    for n, x in gp.items():
        if n.endswith("k_proj.bias"):
            assert max(gk[n].abs().max(), x.abs().max()) <= gtol * gmax, n
        else:
            assert (gk[n] - x).abs().max() <= gtol * x.abs().max(), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["yitrans", "vatlm"])
def test_yitrans_vatlm_kernel_route_matches_plain_route(card, family, dtype):
    """YiTrans and VATLM at Base width (one layer a stack): the kernel
    route against the plain route with the same weights and masks.  Eval:
    YiTrans' speech encoder (2 s and 1.3 s, with CTC) and text encoder (a
    61-token source), VATLM's ``encode_av`` (3 s of 88 x 88 video and
    stacked fbank); train: the pretraining logits (YiTrans' HuBERT and
    denoising logits, VATLM's on audio + video + phones) and the gradients
    of a fixed random projection of them; tolerances as the sibling
    families' test above."""
    from dataclasses import replace

    from speecht5_tpu_torch.config import apply_overrides
    from speecht5_tpu_torch.models.common import init_weights
    from speecht5_tpu_torch.models.speechlm import text_masking
    from speecht5_tpu_torch.models.vatlm import VATLMConfig, VATLMModel
    from speecht5_tpu_torch.models.yitrans import YiTransConfig, YiTransModel
    from speecht5_tpu_torch.ops.masking import sample_feature_masks

    P, M = {"yitrans": (YiTransConfig, YiTransModel),
            "vatlm": (lambda: VATLMConfig(phone_vocab_size=50), VATLMModel)}[family]
    still = [f"{s}.{f}" for s in ("encoder", "decoder") for f in (
        "num_layers=1", "dropout=0.0", "attention_dropout=0.0", "activation_dropout=0.0")]
    cfg = apply_overrides(replace(P(), dtype=str(dtype).split(".")[-1]), still)
    flags = ["encoder.use_pallas_attn=True", "encoder.use_pallas_attn_train=True"]
    if family == "yitrans":
        flags.append("conv_features.impl='pallas'")
    models = [init_weights(M(apply_overrides(cfg, ovs)), torch.Generator().manual_seed(0)).to(card)
              for ovs in (flags, [])]
    models[1].load_state_dict(models[0].state_dict())
    g = torch.Generator().manual_seed(1)
    if family == "yitrans":
        wav = torch.randn(2, 32000, generator=g).to(card) * 0.1
        lens = torch.tensor([32000, 20800], device=card)
        T = cfg.conv_features.out_length(32000)
        src = torch.randint(5, 32000, (2, 61), generator=g).to(card)
        prev = torch.randint(5, 32000, (2, 20), generator=g).to(card)
        masks = sample_feature_masks(cfg.conv_features.out_length(lens.cpu()), T, cfg.d_model,
                                     text_masking(cfg.masking), g)
    else:
        T = 75
        audio = torch.randn(2, T, 104, generator=g).to(card)
        video = torch.randn(2, T, 88, 88, 1, generator=g).to(card)
        lens = torch.tensor([T, 50], device=card)
        phones = torch.randint(4, 50, (2, T), generator=g).to(card)
        masks = sample_feature_masks(lens.cpu(), T, cfg.d_model, text_masking(cfg.masking), g)
    outs = []
    K.reset_launch_counts()
    for m in models:
        with torch.no_grad():
            m.eval()
            if family == "yitrans":
                enc = m.encode_speech(wav, lens, with_ctc=True)
                evals = [enc["encoder_out"], enc["ctc_logits"], m.encode_text(src)["encoder_out"]]
            else:
                evals = [m.encode_av(audio, video, lens)["encoder_out"]]
        m.train()
        if family == "yitrans":
            out = m.forward_pretrain(wav, lens, src, prev, masks=masks)
            logits = [out["speech_logits"], out["text_logits"]]
        else:
            logits = m.forward_pretrain(audio, video, lens, phone_tokens=phones,
                                        masks=masks)["logits"]
        gp = torch.Generator().manual_seed(2)
        sum((x.float() * torch.randn(x.shape, generator=gp).to(card)).sum()
            for x in logits).backward()
        outs.append(([e.float() for e in evals], [x.detach().float() for x in logits],
                     {n: p.grad.float() for n, p in m.named_parameters()
                      if p.grad is not None}))
    counts = K.launch_counts()
    assert counts["banded_flash_attention"] > 0 and counts["banded_attention_train_fwd"] > 0
    assert (counts["conv_stack"] > 0) == (family == "yitrans"), counts
    (ek, lk, gk), (ep, lp, gp) = outs
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, b in zip(ek + lk, ep + lp):
        assert (a - b).abs().max() <= tol * b.abs().max()
    gtol = 1e-3 if dtype == torch.float32 else 3e-2
    assert set(gk) == set(gp)
    gmax = max(x.abs().max() for x in gp.values())
    for n, x in gp.items():
        if n.endswith("k_proj.bias"):
            assert max(gk[n].abs().max(), x.abs().max()) <= gtol * gmax, n
        else:
            assert (gk[n] - x).abs().max() <= gtol * x.abs().max(), n
