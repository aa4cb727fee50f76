"""Step-numbered .npz checkpoints of variables + optimizer state.

Replaces the reference's Keras per-epoch weight snapshots and
JSON-architecture-plus-h5 resume flow (`modules/lidar/train/train.py:
183-195,229-230,286`; `model.py:195-209`). One file per step,
`ckpt_<step>.npz`, holds the variables (`params/...`, `batch_stats/...`)
and the optax state's leaves in tree order (`opt/<i>`). Files are written
to a temporary name, synced and renamed, so a crash never leaves a
half-written "latest" checkpoint. Resume restores exactly — optimizer
moments included, which Keras lost on recompile.
"""

from __future__ import annotations

import os
import re

import jax
import jax.numpy as jnp
import numpy as np

from tpufusion.models.io import flatten, unflatten

_NAME = re.compile(r"^ckpt_(\d+)\.npz$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}.npz")

    def steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        found = (_NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, variables: dict, opt_state=None) -> None:
        os.makedirs(self.directory, exist_ok=True)
        arrays = {k: np.asarray(v) for k, v in flatten(variables).items()}
        if opt_state is not None:
            for i, leaf in enumerate(jax.tree.leaves(opt_state)):
                arrays[f"opt/{i}"] = np.asarray(leaf)
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self.steps()[: -self.keep]:
            os.remove(self._path(old))

    def restore(self, variables: dict, opt_state=None,
                step: int | None = None):
        """-> (step, variables, opt_state) from the checkpoint at `step`
        (default: the latest). `variables` and `opt_state` are templates:
        the restored trees have their structure, shapes and dtypes.
        Without an `opt_state` template only the variables are read
        (inference-time restore of a training checkpoint)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        want = flatten(variables)
        with np.load(self._path(step)) as z:
            stored = {k for k in z.files if not k.startswith("opt/")}
            if stored != set(want):
                diff = sorted(stored.symmetric_difference(want))
                raise ValueError(f"checkpoint/model key mismatch: {diff[:6]}")
            restored = unflatten({
                k: _like(z[k], ref, k) for k, ref in want.items()
            })
            if opt_state is None:
                return step, restored, None
            leaves, treedef = jax.tree.flatten(opt_state)
            n = sum(k.startswith("opt/") for k in z.files)
            if n != len(leaves):
                raise ValueError(
                    f"checkpoint has {n} optimizer leaves, the optimizer "
                    f"{len(leaves)}"
                )
            opt = [_like(z[f"opt/{i}"], ref, f"opt/{i}")
                   for i, ref in enumerate(leaves)]
        return step, restored, jax.tree.unflatten(treedef, opt)


def _like(value: np.ndarray, ref, key: str):
    ref = jnp.asarray(ref)
    if value.shape != ref.shape:
        raise ValueError(f"{key}: stored shape {value.shape} != {ref.shape}")
    return jnp.asarray(value, dtype=ref.dtype)
