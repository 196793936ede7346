"""Time the plain uvu convolution of each production layer against the step.

The uvu convolution is `uvu_plan.apply(x[src], sh, w)` followed by
`scatter_sum` into the destination nodes: one einsum per CG path, left to
XLA, with a `[E, irreps_out.dim]` float32 message array between the two.
This script builds chip_smoke.py's production elasticity model and first
training batch (32 crystals of 4-12 atoms, 5 species), then reports for
every PointConv layer the fwd+bwd time of that convolution alone, its
message size, and the sum of the four against the full train step
(fwd+bwd+Adam). It is the bar a fused gather->CG->segment-sum kernel has
to beat.

Usage: python devtools/uvu_conv_bench.py [iters]
"""

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def timed(fn, n):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / n


def main():
    import jax
    import jax.numpy as jnp

    from chip_smoke import flagship
    from matten_tpu.data import keys as K
    from matten_tpu.nn.conv import PointConv, PointConvWithActivation
    from matten_tpu.ops.scatter import scatter_sum
    from matten_tpu.utils.compile_cache import enable_compile_cache

    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    enable_compile_cache()
    dev = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except FileNotFoundError:
        smi = "n/a"
    print(f"device: {dev.device_kind} ({dev.platform}); nvidia-smi: {smi}")

    with tempfile.TemporaryDirectory() as tmp:
        _, trainer, batch = flagship(Path(tmp))
    model = trainer.model
    real_edges = int(batch[0][K.EDGE_MASK].sum())
    n_pad, e_pad = batch[0][K.POSITIONS].shape[0], batch[0][K.EDGE_MASK].shape[0]
    state = trainer.init_state(batch, rng_seed=35)
    d, t = trainer._to_device(batch)
    holder = {"state": state}

    def step():
        holder["state"], loss, _ = trainer._train_step(holder["state"], d, t)
        return loss

    first, step_s = timed(step, iters)
    print(
        f"train step: batch {int(batch[0][K.GRAPH_MASK].sum())}, {n_pad} padded nodes, {e_pad} padded / "
        f"{real_edges} real edges: first call {first:.1f} s, "
        f"{step_s * 1e3:.3f} ms/step, {real_edges / step_s:.0f} edges/s"
    )

    src, dst = d[K.EDGE_INDEX]
    rng = np.random.default_rng(1)
    total = 0.0
    print("layer            paths  message [E, D] f32      fwd+bwd ms  first call s")
    for layer in model.backbone.layers:
        if isinstance(layer, PointConvWithActivation):
            layer = PointConv(
                irreps_in=layer.irreps_in,
                conv_layer_irreps=layer._act_info().irreps_in,
                name=layer.name,
            )
        elif not isinstance(layer, PointConv):
            continue
        uvu = layer._plans()[2]
        args = [
            jnp.asarray(rng.normal(size=s), jnp.float32)
            for s in (
                (n_pad, uvu.irreps_in1.dim),
                (e_pad, uvu.irreps_in2.dim),
                (e_pad, uvu.weight_numel),
                (n_pad, uvu.irreps_out.dim),
            )
        ]

        def fwd_bwd(x, sh, w, g, uvu=uvu):
            conv = lambda x, w: scatter_sum(uvu.apply(x[src], sh, w), dst, n_pad)  # noqa: E731
            out, vjp = jax.vjp(conv, x, w)
            return (out,) + vjp(g)

        fb = jax.jit(fwd_bwd)
        first, t_s = timed(lambda: fb(*args), iters)
        total += t_s
        mib = e_pad * uvu.irreps_out.dim * 4 / 2**20
        print(
            f"{layer.name:16s} {len(uvu.instructions):5d}  "
            f"[{e_pad}, {uvu.irreps_out.dim}] = {mib:6.1f} MiB  "
            f"{t_s * 1e3:10.3f}  {first:12.1f}"
        )
    print(
        f"all uvu convolutions: {total * 1e3:.3f} ms fwd+bwd = "
        f"{total / step_s:.1%} of the train step"
    )


if __name__ == "__main__":
    main()
