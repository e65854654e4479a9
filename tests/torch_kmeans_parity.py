"""Where the IVF builds of the two packages part, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_kmeans_parity.py

(a few seconds; pytest does not collect it). On the slice test's pool
(`make_pool(default_rng(0), 20756, 32, 64)`, first 20,000 rows) it prints
one JSON line:
- `norms_differ`: the share of rows whose ‖x‖² from `prep_norms`
  (torch.sum) differs from the reference's jitted norms, and the same for
  `chain_norms` (the k-means norms the port takes);
- `first_lloyd_round_apart`: the first of 8 Lloyd rounds from the same
  seeds after which the two packages' centroids differ (null: none), with
  each of the two norms;
- `bf16_dot`: on 4096 rows x 300 centroids, the share of entries where the
  reference's bf16 `dot_general` (f32 accumulate) differs from its own
  f32 dot of the same bf16-rounded operands, and from a sequential fp32
  sum of their products: the order of the XLA:CPU kernel, which depends
  on the machine;
- `cells`: the real cell counts of the two builds.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from turdb_tpu.models import ivf as R
from turdb_tpu.models.ivf import IvfIndex as JaxIvf
from turdb_tpu.ops.distance import prep_norms as jax_norms
from turdb_tpu_torch.models import ivf as P
from turdb_tpu_torch.ops.distance import chain_norms, prep_norms
from turdb_tpu_torch.utils.datasets import make_pool

torch.set_num_threads(1)
N, DIM, C = 20_000, 32, 312


def first_round_apart(x, norms):
    seeds = np.random.default_rng(0).choice(N, C, replace=False)
    xp = jnp.asarray(R._pad_rows(x, R._KM_CHUNK))
    rc = jnp.concatenate([xp[jnp.asarray(seeds)],
                          jnp.full((R._cpad(C) - C, DIM), R._PAD_CENT, jnp.float32)])
    pc = torch.from_numpy(x[seeds])
    real = P.chain_norms
    P.chain_norms = norms
    try:
        for it in range(8):
            rc = R._kmeans(xp, rc, iters=1)
            pc = P._kmeans(torch.from_numpy(x), pc, 1)
            if not np.array_equal(np.asarray(rc)[:C], pc.numpy()):
                return it + 1
    finally:
        P.chain_norms = real
    return None


def bf16_dot(x):
    q, c = x[:4096], x[4096:4396]
    bf = jax.jit(lambda a, b: jax.lax.dot_general(
        a.astype(jnp.bfloat16), b.astype(jnp.bfloat16), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32))(q, c)
    qb = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    cb = np.asarray(jnp.asarray(c).astype(jnp.bfloat16).astype(jnp.float32))
    f32 = jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), precision=jax.lax.Precision.HIGHEST))(qb, cb)
    seq = np.zeros((len(q), len(c)), np.float32)
    for j in range(DIM):
        seq = (seq + qb[:, None, j] * cb[None, :, j]).astype(np.float32)
    bf = np.asarray(bf)
    return {"vs_own_f32_dot": float(np.mean(bf != np.asarray(f32))),
            "vs_sequential_sum": float(np.mean(bf != seq))}


def main():
    x = make_pool(np.random.default_rng(0), N + 756, DIM, n_clusters=64)[:N]
    want = np.asarray(jax_norms(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    ref = JaxIvf(dim=DIM)
    ref.add(x)
    port = P.IvfIndex(dim=DIM, device="cpu")
    port.add(x)
    print(json.dumps({
        "norms_differ": {"prep_norms": float(np.mean(prep_norms(xt).numpy() != want)),
                         "chain_norms": float(np.mean(chain_norms(xt).numpy() != want))},
        "first_lloyd_round_apart": {"prep_norms": first_round_apart(x, prep_norms),
                                    "chain_norms": first_round_apart(x, chain_norms)},
        "bf16_dot": bf16_dot(x),
        "cells": {"reference": int(np.isfinite(np.asarray(ref.state.cnorms)).sum()),
                  "port": port.cfg.n_clusters},
    }))


if __name__ == "__main__":
    main()
