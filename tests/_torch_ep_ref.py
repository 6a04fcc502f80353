"""Reference run for the port's expert-parallel MoE and compressed-mean
tests, in a process of its own with 8 forced host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        PYTHONPATH=src python tests/_torch_ep_ref.py IN.npz OUT.npz

IN.npz holds the numpy inputs a test module made: the MoE cases
(``moe/...`` weights, ``x``, ``moe_dims``, the capacity ``factors``) or the
compression cases (``g/<case>/<step>`` gradients, ``ef/<case>`` initial
residuals, ``steps``), or both. OUT.npz gets the reference's
``moe_forward_ep`` output and aux metrics on a (2, 4) ("data", "model")
mesh at each capacity factor, each shard's kept pairs (its ``route`` and
``_local_dispatch``), and ``compressed_psum_mean`` on a 4-device
("data",) mesh: each step's mean and residual, chained through the
residuals, and the int8 codes of both quantizations (the reference's body,
re-run with its own ``_quantize``; its output is checked here to be the
function's, bit for bit). Forward only.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.compat import make_mesh, shard_map  # noqa: E402
from repro.launch.partition import partitioning  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.moe_ep import _local_dispatch, moe_forward_ep  # noqa: E402
from repro.optim import compression as jc  # noqa: E402

RULES = {"tokens": ("data",), "expert": ("model",), "fsdp": None,
         "moe_impl": "shard_map_ep"}


def moe_cases(inp, out):
    mesh = make_mesh((2, 4), ("data", "model"))
    params = {"router": {"kernel": jnp.asarray(inp["moe/router/kernel"])},
              **{k: jnp.asarray(inp[f"moe/{k}"]) for k in ("wi", "wg", "wo")},
              "shared": {k: {"kernel": jnp.asarray(inp[f"moe/shared/{k}"])}
                         for k in ("wi", "wg", "wo")}}
    x = jnp.asarray(inp["x"])
    e, k, d, f = (int(v) for v in inp["moe_dims"])
    for cf in inp["factors"]:
        cfg = jmoe.MoEConfig(d_model=d, n_experts=e, top_k=k, d_expert=f,
                             n_shared_experts=1, capacity_factor=float(cf))
        with partitioning(mesh, RULES) as merged:
            y, m = jax.jit(lambda p, xx: moe_forward_ep(
                p, xx, cfg, mesh, merged))(params, x)
        tag = f"cf{float(cf):g}"
        out[f"{tag}/out"] = np.asarray(y.astype(jnp.float32))
        for name, v in m.items():
            out[f"{tag}/{name}"] = np.asarray(v)

        def keep_of(xb, router_k):
            b, s, dd = xb.shape
            flat = xb.reshape(b * s, dd)
            logits = flat.astype(jnp.float32) @ router_k
            weights, idx, _ = jmoe.route(logits, cfg)
            c = jmoe.capacity(b * s, cfg)
            _, (_, _, _, _, keep) = _local_dispatch(flat, weights, idx, e, c)
            return keep[None, None], idx[None, None]
        fn = shard_map(keep_of, mesh=mesh,
                       in_specs=(P("data", "model", None), P(None, None)),
                       out_specs=(P("data", "model"),) * 2, check_vma=False)
        keep, idx = jax.jit(fn)(x, params["router"]["kernel"])
        out[f"{tag}/keep"] = np.asarray(keep)
        out[f"{tag}/idx"] = np.asarray(idx)


def compressed_cases(inp, out):
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    n = 4

    def body(g, ef):
        # the reference's compressed_psum_mean, its codes kept
        g, ef = g[0], ef[0]
        shape = g.shape
        orig = g.size
        flat = (g + ef).reshape(-1)
        pad = (-flat.shape[0]) % n
        if pad:
            flat = jnp.pad(flat, (0, pad))
        q, scale = jc._quantize(flat)
        chunks = q.reshape(n, -1)
        recv = jax.lax.all_to_all(chunks, "data", 0, 0)
        recv_scales = jax.lax.all_gather(scale, "data")
        summed = jnp.sum(recv.astype(jnp.float32) * recv_scales[:, None],
                         axis=0) / n
        q2, s2 = jc._quantize(summed)
        all_q = jax.lax.all_gather(q2, "data")
        all_s = jax.lax.all_gather(s2, "data")
        again = (all_q.astype(jnp.float32) * all_s[:, None]).reshape(-1)
        mean, new_ef = jc.compressed_psum_mean(g, "data", ef)
        same = jnp.all(again[:orig].reshape(shape) == mean)
        return (mean[None], new_ef[None], q[None], q2[None], same[None])

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"),) * 5, check_vma=False))
    cases = sorted({key.split("/")[1] for key in inp.files
                    if key.startswith("g/")})
    for case in cases:
        ef = jnp.asarray(inp[f"ef/{case}"])
        for step in range(int(inp["steps"])):
            g = jnp.asarray(inp[f"g/{case}/{step}"])
            mean, ef, q, q2, same = fn(g, ef)
            assert bool(np.all(np.asarray(same))), (case, step)
            out[f"c/{case}/{step}/mean"] = np.asarray(mean)
            out[f"c/{case}/{step}/ef"] = np.asarray(ef)
            out[f"c/{case}/{step}/q"] = np.asarray(q)
            out[f"c/{case}/{step}/q2"] = np.asarray(q2)


def main():
    inp = np.load(sys.argv[1])
    out: dict = {}
    if "x" in inp.files:
        moe_cases(inp, out)
    if "steps" in inp.files:
        compressed_cases(inp, out)
    np.savez(sys.argv[2], **out)
    print("EP-REF-OK")


if __name__ == "__main__":
    main()
