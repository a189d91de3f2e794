"""The port's RNG (pcg4d stream and threefry key words) is bit-equal to the
JAX reference's: ops/rng.py and jax.random in its default partitionable
threefry mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracingthenextweekcuda_tpu.ops import rng as jrng
from raytracingthenextweekcuda_tpu_torch.ops import rng as trng
from raytracingthenextweekcuda_tpu_torch.ops import threefry


def _words(seed, n=2048, k=4):
    r = np.random.default_rng(seed)
    return [r.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
            for _ in range(k)]


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcg4d_and_to_uniform_bit_equal(seed):
    a, b, c, d = _words(seed)
    ref = jrng.pcg4d(*(jnp.asarray(v) for v in (a, b, c, d)))
    out = trng.pcg4d(*(_t(v) for v in (a, b, c, d)))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64), o.numpy())
        np.testing.assert_array_equal(np.asarray(jrng.to_uniform(r)),
                                      trng.to_uniform(o).numpy())


@pytest.mark.parametrize("seed", [3, 4])
def test_uniform_streams_bit_equal(seed):
    pid, b0, b1, _ = _words(seed)
    ctx = jrng.RayCtx(jnp.asarray(pid), jnp.uint32(b0[0]), jnp.uint32(b1[0]))
    p, w0, w1 = _t(pid), int(b0[0]), int(b1[0])
    np.testing.assert_array_equal(np.asarray(jrng.raygen_uniforms(ctx)),
                                  trng.raygen_uniforms(p, w0, w1).numpy())
    np.testing.assert_array_equal(np.asarray(jrng.shutter_uniform(ctx)),
                                  trng.shutter_uniform(p, w0, w1).numpy())
    for bounce in (0, 1, 9):
        np.testing.assert_array_equal(
            np.asarray(jrng.bounce_uniforms(ctx, bounce)),
            trng.bounce_uniforms(p, w0, w1, bounce).numpy())
    np.testing.assert_array_equal(
        np.asarray(jrng.uniforms4(ctx, jnp.uint32(12345))),
        trng.uniforms4(p, w0, w1, 12345).numpy())


def test_threefry_pinned_words():
    k = threefry.key(1984)
    np.testing.assert_array_equal(k, [0, 1984])
    f = threefry.fold_in(k, 0)
    np.testing.assert_array_equal(f, [2310321206, 3390240906])
    np.testing.assert_array_equal(
        threefry.split(f, 3),
        [[945237983, 2289393525], [2908283638, 2038268504],
         [3593791974, 3110203706]])


@pytest.mark.parametrize("seed", [0, 1, 7, 1984, 2**31 - 1])
def test_threefry_matches_jax_random(seed):
    jk = jax.random.key(seed)
    k = threefry.key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)), k)
    for i in (0, 1, 5, 1000):
        jp = jax.random.fold_in(jk, i)
        p = threefry.fold_in(k, i)
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(jp)), p)
        for n in (1, 2, 3, 8, 33):
            np.testing.assert_array_equal(
                np.asarray(jax.random.key_data(jax.random.split(jp, n))),
                threefry.split(p, n))
