"""Checkpoint and resume (counterpart of
raytracingthenextweekcuda_tpu/models/checkpoint.py).

The film of a long render (its radiance sum and sample count), the seed,
the passes done and a fingerprint of the scene and camera go to one .npz,
so that a render can be killed and resumed, and a stale checkpoint (another
scene or camera) is refused instead of blended in. The file's keys are the
reference's (`accum`, `sample_count`, `meta`), so a film the reference
saved loads here. Also the state of an inverse-rendering run: parameters
and a torch.optim.Adam state_dict.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.models.film import Film


def _leaves(tree):
    """The arrays of a scene, camera or tuple of them, in the order of the
    reference's pytree leaves (dataclass fields in order; None has none)."""
    if tree is None:
        return
    if torch.is_tensor(tree):
        yield tree.detach().cpu().numpy()
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


def _fingerprint(tree) -> str:
    """Content hash of a scene and camera (their arrays' types, shapes and
    bytes). An unfinalized scene hashes as in the reference, whose Scene
    lists the same arrays in the same order."""
    h = hashlib.sha256()
    for arr in _leaves(tree):
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def _save_npz(path: str, **arrays) -> None:
    """np.savez_compressed to exactly `path` (numpy would add ".npz" to a
    name without it), through a temporary file, so that a render killed
    while it writes keeps its last checkpoint."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def save_render_state(path: str, film: Film, seed: int, passes_done: int,
                      scene=None, camera=None, cfg=None) -> None:
    meta = {
        "seed": int(seed),
        "passes_done": int(passes_done),
        "fingerprint": _fingerprint((scene, camera)) if scene is not None else "",
        "cfg": dataclasses.asdict(cfg) if cfg is not None else {},
    }
    _save_npz(path, accum=film.accum.detach().cpu().numpy(),
              sample_count=np.asarray(film.sample_count, np.int32),
              meta=json.dumps(meta))


def load_render_state(path: str, scene=None, camera=None, device="cpu"):
    """Returns (film on `device`, seed, passes_done). Raises ValueError on a
    stale checkpoint when a scene (and camera) is given to check it by."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        if scene is not None and meta.get("fingerprint"):
            now = _fingerprint((scene, camera))
            if now != meta["fingerprint"]:
                raise ValueError(f"stale checkpoint {path}: scene/camera changed "
                                 f"({meta['fingerprint']} -> {now})")
        film = Film(torch.from_numpy(np.asarray(z["accum"], np.float32)).to(device),
                    int(z["sample_count"]))
        return film, meta["seed"], meta["passes_done"]


def render_resumable(scene, camera, cfg, checkpoint_path=None, device="cuda",
                     after_pass=None) -> Film:
    """Offline render, pass by pass. With a `checkpoint_path`, it resumes
    from that file if it exists and is fresh, and saves its film there
    after each pass; with None, it neither loads nor saves. Pass i renders
    with the key fold_in(key(cfg.seed), i) (ops/threefry), as
    integrator.render does, so a resumed film equals a straight render bit
    for bit. `after_pass(i, film)`, if given, runs after each pass."""
    from raytracingthenextweekcuda_tpu_torch.models import integrator
    from raytracingthenextweekcuda_tpu_torch.ops import threefry
    from raytracingthenextweekcuda_tpu_torch.ops.cuda.launch import device_or_raise

    device = device_or_raise(device)
    key = threefry.key(cfg.seed)
    start_pass = 0
    film = Film.create(cfg.width, cfg.height, device=device)
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        film, _, start_pass = load_render_state(checkpoint_path, scene, camera, device)
    passes = cfg.passes()
    for i in range(start_pass, len(passes)):
        chunk = passes[i]
        film = film.add(integrator.render_pass(scene, camera, threefry.fold_in(key, i),
                                               cfg, chunk, device=device), chunk)
        if checkpoint_path is not None:
            save_render_state(checkpoint_path, film, cfg.seed, i + 1, scene, camera, cfg)
        if after_pass is not None:
            after_pass(i, film)
    return film


def save_fit_state(path: str, params, opt_state: dict, step: int) -> None:
    """Save a fit: its parameters (a sequence of tensors), an optimizer's
    state_dict (tensors per parameter index, plus its param_groups) and the
    step."""
    arrays = {f"p{i}": p.detach().cpu().numpy() for i, p in enumerate(params)}
    keys = {}
    for idx, entry in opt_state["state"].items():
        keys[str(idx)] = sorted(entry)
        for name, value in entry.items():
            arrays[f"o{idx}.{name}"] = torch.as_tensor(value).detach().cpu().numpy()
    meta = {"step": int(step), "n_params": len(params), "state_keys": keys,
            "param_groups": opt_state["param_groups"]}
    _save_npz(path, meta=json.dumps(meta), **arrays)


def load_fit_state(path: str, device="cpu"):
    """Returns (the parameters as a list of tensors on `device`, the
    optimizer state_dict for `load_state_dict`, on the CPU, which moves it
    to the parameters' device, and the step)."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        params = [torch.from_numpy(z[f"p{i}"]).to(device)
                  for i in range(meta["n_params"])]
        state = {int(idx): {name: torch.from_numpy(z[f"o{idx}.{name}"])
                            for name in names}
                 for idx, names in meta["state_keys"].items()}
    groups = [{k: tuple(v) if k == "betas" else v for k, v in g.items()}
              for g in meta["param_groups"]]
    return params, {"state": state, "param_groups": groups}, meta["step"]


__all__ = ["load_fit_state", "load_render_state", "render_resumable",
           "save_fit_state", "save_render_state"]
