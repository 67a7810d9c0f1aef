"""Flash attention's backward in the port against the reference, on the
CPU: ``models/flash.py`` (the plain forward with its log-sum-exp, then
``flash_backward``) against ``jax.grad`` through the reference's custom
VJP (``repro.models.flash._bwd_impl``), over global, local and bidir
attention, cap 0 and 50, G 1 and 2, S 512 and 1024 (one and two 512-row
blocks) at fp32 and bf16; the plain lse against ``_fwd_impl``'s. The CUDA
kernel's lse and the backward behind it are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 12).

Tolerances:
  * the plain lse within 1e-6 of the case's max |lse| (values of 5-60
    where an fp32 ulp is 5e-7-4e-6; rows near 0 differ by as much as the
    large ones);
  * dq, dk, dv within 1e-5 of each gradient's max |g| at fp32 inputs (both
    are fp32 blockwise computations differing in summation order; measured
    <= 2e-6). At bf16 inputs within 2**-7 of max |g|: each gradient is
    rounded once to bf16 (2**-9 of an element) and the forward's bf16
    output, which delta = dout . out reads, may sit one bf16 ulp apart
    (measured <= 1.4e-3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import flash as jflash  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402

torch.set_num_threads(2)

LSE_RTOL = 1e-6
FLASH_TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _flash_inputs(B, S, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [512, 1024])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("kind", ["global", "local", "bidir"])
def test_flash_backward_matches_reference(kind, cap, G, S, dtype):
    """dq, dk, dv of models/flash.py (plain forward with its lse, then
    flash_backward) against jax.grad through the reference's custom VJP,
    and the plain lse against _fwd_impl's; q scaled so the cap bites."""
    K, hd = 2, 32
    window = 300 if kind == "local" else 0
    q, k, v, do = _flash_inputs(1, S, K * G, K, hd, seed=S + 10 * G)
    q = q * (4.0 if cap else 1.0)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    qj, kj, vj = (jnp.asarray(a, jd) for a in (q, k, v))

    def f(q, k, v):
        o = jflash.flash_attention(q, k, v, kind, window, cap)
        return jnp.sum(o.astype(jnp.float32) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(qj, kj, vj)
    qt, kt, vt = (torch.from_numpy(a).to(td).requires_grad_(True)
                  for a in (q, k, v))
    out = tflash.flash_attention(qt, kt, vt, kind, window, cap,
                                 kernel="ref")
    got = torch.autograd.grad((out.float() * torch.from_numpy(do)).sum(),
                              (qt, kt, vt))
    for name, a, b in zip(("dq", "dk", "dv"), want, got):
        assert b.dtype == td
        a, b = _np(a), _np(b)
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= FLASH_TOL[dtype], (name, err)
    if dtype == "f32":
        _, lse_j = jflash._fwd_impl(qj, kj, vj, kind, window, cap, 512, 512)
        _, lse_t = tref.flash_attention_ref(
            qt.detach(), kt.detach(), vt.detach(), causal=kind != "bidir",
            window=window, cap=cap, return_lse=True)
        lj = np.asarray(lse_j)
        assert lse_t.shape == lj.shape and lse_t.dtype == torch.float32
        np.testing.assert_allclose(lse_t.numpy(), lj, rtol=0,
                                   atol=LSE_RTOL * np.abs(lj).max())


def test_flash_without_grad_saves_nothing():
    """Serving: tensors that need no gradient give the plain forward with
    no lse and no graph; with one, the backward runs."""
    q, k, v, _ = _flash_inputs(1, 512, 4, 2, 32, seed=1)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out = tflash.flash_attention(qt, kt, vt, "global", kernel="ref")
    assert out.grad_fn is None
    torch.testing.assert_close(out, tref.flash_attention_ref(qt, kt, vt),
                               rtol=0, atol=0)
    qg = qt.clone().requires_grad_(True)
    out = tflash.flash_attention(qg, kt, vt, "global", kernel="ref")
    torch.testing.assert_close(out, tref.flash_attention_ref(qt, kt, vt),
                               rtol=0, atol=0)
    out.sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()


