"""Chained microbench of the node-mixing FCTPs (sc/lin1/lin2).

Times each formulation of the species-conditioned fully-connected TPs that
wrap every conv layer (`apply`, `apply_scalar_dense`, `apply_scalar_matmul`
in f32 and bf16, `apply_onehot2`) at production widths, K_CHAIN steps per
dispatch.

Usage: python devtools/fctp_bench.py [iters] [num_species]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K_CHAIN = 8


def main():
    import jax
    import jax.numpy as jnp

    from matten_tpu.nn.conv import _conv_plans
    from matten_tpu.ops.irreps import Irreps

    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    n = 384
    n_species = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    feats = Irreps("32x0o+32x0e+16x1o+16x1e+4x2o+4x2e+2x3o+2x3e+2x4e")
    sh_ir = Irreps("0e+1o+2e+3o+4e")
    sc, lin1, uvu, lin2 = _conv_plans(feats, Irreps(f"{n_species}x0e"), sh_ir, feats)
    print(
        f"backend={jax.default_backend()} n={n} S={n_species} "
        f"sc_w={sc.weight_numel} lin1_w={lin1.weight_numel} lin2_w={lin2.weight_numel}"
    )

    rng = np.random.default_rng(0)
    key = lambda shape: jnp.asarray(rng.normal(size=shape), jnp.float32)
    x = key((n, feats.dim))
    mid = key((n, uvu.irreps_out.dim))
    sp_idx = jnp.asarray(rng.integers(0, n_species, n))
    attrs = jax.nn.one_hot(sp_idx, n_species, dtype=jnp.float32)
    w_sc = key((sc.weight_numel,))
    w_l1 = key((lin1.weight_numel,))
    w_l2 = key((lin2.weight_numel,))

    def layer(x, mid, w_sc, w_l1, w_l2, variant="apply"):
        if variant == "dense":
            f = lambda p, a, w: p.apply_scalar_dense(a, attrs, w)
        elif variant == "matmul":
            f = lambda p, a, w: p.apply_scalar_matmul(a, attrs, w)
        elif variant == "matmul_bf16":
            f = lambda p, a, w: p.apply_scalar_matmul(
                a, attrs, w, operand_dtype=jnp.bfloat16
            )
        elif variant == "onehot2":
            f = lambda p, a, w: p.apply_onehot2(a, sp_idx, w)
        else:
            f = lambda p, a, w: p.apply(a, attrs, w)
        a = f(sc, x, w_sc)
        b = f(lin1, x, w_l1)
        c = f(lin2, mid, w_l2)
        return a + c + jnp.pad(b, [(0, 0), (0, a.shape[1] - b.shape[1])])

    def chained(grad_args, variant="apply"):
        def loss(x, mid, w_sc, w_l1, w_l2):
            return (layer(x, mid, w_sc, w_l1, w_l2, variant=variant) ** 2).sum() * 1e-6

        if grad_args:
            step = jax.grad(loss, argnums=grad_args)
        else:
            step = loss

        def run(x, mid, w_sc, w_l1, w_l2):
            def body(_, acc):
                r = step(acc, mid, w_sc, w_l1, w_l2)
                first = r[0] if isinstance(r, tuple) else r
                if first.ndim == 0:
                    return acc + 1e-30 * first
                return acc + 1e-30 * first

            return jax.lax.fori_loop(0, K_CHAIN, body, x)

        return jax.jit(run)

    def timeit(fn, *args):
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / (iters * K_CHAIN)

    t_f = timeit(chained(()), x, mid, w_sc, w_l1, w_l2)
    print(f"sc+lin1+lin2 fwd (1 layer)      : {t_f*1e3:7.3f} ms")
    t_b = timeit(chained((0, 2, 3, 4)), x, mid, w_sc, w_l1, w_l2)
    print(f"sc+lin1+lin2 fwd+bwd (1 layer)  : {t_b*1e3:7.3f} ms")
    t_fd = timeit(chained((), variant="dense"), x, mid, w_sc, w_l1, w_l2)
    print(f"scalar_dense fwd (1 layer)      : {t_fd*1e3:7.3f} ms")
    t_bd = timeit(chained((0, 2, 3, 4), variant="dense"), x, mid, w_sc, w_l1, w_l2)
    print(f"scalar_dense fwd+bwd (1 layer)  : {t_bd*1e3:7.3f} ms")
    for variant in ("matmul", "matmul_bf16", "onehot2"):
        t_fm = timeit(chained((), variant=variant), x, mid, w_sc, w_l1, w_l2)
        print(f"{variant:15s} fwd (1 layer)   : {t_fm*1e3:7.3f} ms")
        t_bm = timeit(chained((0, 2, 3, 4), variant=variant), x, mid, w_sc, w_l1, w_l2)
        print(f"{variant:15s} fwd+bwd         : {t_bm*1e3:7.3f} ms")


if __name__ == "__main__":
    main()
