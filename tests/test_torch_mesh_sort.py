"""The port's wavefront coherence key against the JAX reference (bit for
bit: integer quantization of the same float32 slab and grid arithmetic),
and the unsort that restores wavefront order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu.ops import wavefront_sort as jsort
from raytracingthenextweekcuda_tpu_torch.ops import wavefront_sort as tsort


def _rays(n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # Axis-aligned, zero and denormal-small components exercise the
    # quantizer's clamps and the slab test's safe inverse.
    d[: n // 16, g.integers(0, 3)] = 0.0
    d[n // 16: n // 8] = np.sign(d[n // 16: n // 8]) * np.float32(1e-30)
    d[n // 8: n // 8 + 8] = -5.0  # non-unit, every |d| bucket maxed
    alive = g.random(n) > 0.2
    return o, d, alive


@pytest.mark.parametrize("box", [((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                                 ((-0.45, -0.45, -0.75), (0.45, 0.45, 0.15)),
                                 ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))],
                         ids=["unit", "mesh", "degenerate"])
def test_sort_key_bit_equal(box, monkeypatch):
    monkeypatch.delenv("RTNW_KEY_DIRBITS", raising=False)  # the default, 2
    o, d, alive = _rays(4096, seed=0)
    lo, hi = (np.asarray(b, np.float32) for b in box)
    ref = np.asarray(jsort.ray_sort_key(
        *(jnp.asarray(o[:, a]) for a in range(3)),
        *(jnp.asarray(d[:, a]) for a in range(3)),
        jnp.asarray(alive.astype(np.int32)), jnp.asarray(lo), jnp.asarray(hi)))
    out = tsort.ray_sort_key(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(alive), torch.from_numpy(lo),
                             torch.from_numpy(hi))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(ref, out.numpy())
    assert (out.numpy()[~alive] == tsort.DEAD_KEY).all()
    assert (out.numpy()[alive] < tsort.DEAD_KEY).all()


def test_unsort_inverts_the_permutation():
    g = np.random.default_rng(1)
    n = 1000
    rad = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32))
    perm = torch.from_numpy(g.permutation(n))
    out = tsort.unsort_radiance(perm, rad[perm], n)
    np.testing.assert_array_equal(out.numpy(), rad.numpy())
