"""Where the port's chunked prefill parts from the JAX reference on a
12-row chunk of 4 sequences, on the CPU: tiny gemma2-2b at the reference's
initialisation in fp32, a bf16 pool of 41 pages of 8 keys, chunks starting
at positions 0, 8, 21 and 60 (tests/test_torch_sharded.py's inputs). Every
row of the chunk is unembedded, as the test does.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/chunk_pool_flip.py

Three passes of the port's ``prefill_chunk_paged`` against the
reference's compiled one:

1. as it is: each row's max |logit difference|, against the fp32 rule of
   tests/test_torch_models.py (2e-4);
2. the bf16 pool elements this chunk wrote that differ between the two
   pools, layer by layer, with the port's fp32 value before rounding and
   where it lies between the two bf16 neighbours (0 is the port's, 1 the
   reference's; 0.5 is the rounding boundary);
3. the port again, every pool write replaced by the reference's bf16
   values at the same slots (``write_kv`` wrapped): each row's max |logit
   difference| once the pools agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import tiny_config as j_tiny
from repro.models.api import build_model as j_build
from repro_torch.configs import tiny_config
from repro_torch.models import attention as tattn
from repro_torch.models.api import build_model
from repro_torch.models.convert import from_jax_params

FP32_LOGIT_TOL = 2e-4
PAGE, N_BLOCKS, B, SQ = 8, 10, 4, 12


def inputs(cfg):
    """tests/test_torch_sharded.py::_decode_inputs's chunk case."""
    rng = np.random.default_rng(2)
    pt = np.zeros((B, N_BLOCKS), np.int32)
    perm = rng.permutation(np.arange(1, B * N_BLOCKS + 1))
    for b in range(B):
        pt[b] = perm[b * N_BLOCKS:(b + 1) * N_BLOCKS]
    rng.integers(2, cfg.vocab_size, (B, 1))           # the decode tokens
    chunk = rng.integers(2, cfg.vocab_size, (B, SQ)).astype(np.int32)
    prng = np.random.default_rng(1)                   # _pool_state, seed 1
    shape = (cfg.num_layers // 2, B * N_BLOCKS + 1, PAGE, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    pool = {f"sub{j}": {kv: np.asarray(jnp.asarray(
        prng.standard_normal(shape), jnp.bfloat16)).astype(np.float32)
        for kv in ("k", "v")} for j in range(2)}
    return pool, pt, chunk, np.array([0, 8, 21, 60], np.int32)


def main():
    jcfg = j_tiny("gemma2-2b")
    jm = j_build(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if a.dtype == jnp.bfloat16 else a,
                      jm.init(jax.random.PRNGKey(0)))
    pool, pt, chunk, pos = inputs(jcfg)

    jpool = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pool)
    jh, jout = jax.jit(jm.prefill_chunk_paged)(
        jp, jpool, jnp.asarray(pt), jnp.asarray(chunk), jnp.asarray(pos))
    want = np.asarray(jax.jit(jm.unembed)(jp, jh), np.float32)
    jout = jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a, np.float32)).bfloat16(), jout)

    torch.set_num_threads(1)
    model = build_model(tiny_config("gemma2-2b"))
    p = from_jax_params(jax.tree.map(np.asarray, jp))
    bases = {}                        # storage pointer -> (sub, kv)
    seen = []                         # (sub, kv, group, index, fp32 value)
    force = {"on": False}
    write = tattn.write_kv

    def spy(view, index, new):
        write(view, index, new)
        sub, kv, base = bases[view.untyped_storage().data_ptr()]
        g = view.storage_offset() // base.stride(0)
        seen.append((sub, kv, g, index, new.detach().clone()))
        if force["on"]:
            view[index] = jout[sub][kv][g][index]

    def run(forced):
        tpool = {s: {kv: torch.from_numpy(a).bfloat16() for kv, a in d.items()}
                 for s, d in pool.items()}
        bases.clear()
        for s, d in tpool.items():
            for kv, t in d.items():
                bases[t.untyped_storage().data_ptr()] = (s, kv, t)
        seen.clear()
        force["on"] = forced
        tattn.write_kv = spy
        try:
            with torch.no_grad():
                h, out = model.prefill_chunk_paged(
                    p, tpool, torch.from_numpy(pt), torch.from_numpy(chunk),
                    torch.from_numpy(pos), kernel="ref")
                got = model.unembed(p, h).float().numpy()
        finally:
            tattn.write_kv = write
        return got, out

    def rows(got):
        err = np.abs(got - want).max(-1)              # (B, SQ)
        return err, [(b, t) for b, t in zip(*np.nonzero(
            err > FP32_LOGIT_TOL))]

    got, out = run(False)
    err, over = rows(got)
    print(f"as it is: max |logit diff| {err.max():.6g}, rows over "
          f"{FP32_LOGIT_TOL}: {[(int(b), int(t), float(err[b, t])) for b, t in over]}")

    flips = 0
    for sub, kv, g, index, new in seen:
        a = out[sub][kv][g][index].float()
        r = jout[sub][kv][g][index].float()
        diff = (a != r).nonzero().tolist()
        flips += len(diff)
        for i in diff[:4]:
            x, lo, hi = (float(new[tuple(i)]), float(a[tuple(i)]),
                         float(r[tuple(i)]))
            print(f"  {sub}.{kv} group {g} element {tuple(i)}: port fp32 "
                  f"{x!r} -> bf16 {lo!r}, reference bf16 {hi!r}; at "
                  f"{(x - lo) / (hi - lo):.6f} from the port's bf16 to "
                  f"the reference's")
    n = sum(int(s[4].numel()) for s in seen)
    print(f"pool elements written by the chunk that differ: {flips} of {n}")

    got, _ = run(True)
    err, over = rows(got)
    print(f"the reference's bf16 writes in the port: max |logit diff| "
          f"{err.max():.6g}, rows over {FP32_LOGIT_TOL}: {len(over)}")


if __name__ == "__main__":
    main()
