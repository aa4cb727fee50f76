"""Process set-up for the GPU: compile cache, device guards, the
framework-free import of the main path, and the GPU-vs-CPU check that
runs only on the card."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_extra=None, cwd=REPO, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) else [
        sys.executable, "-c", code_or_args
    ]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR is honoured as set and nothing is set in
    code; without it the cache is the fixed <repo>/.jax_cache."""
    code = (
        "import jax; from tpufusion.utils.device import enable_compile_cache"
        " as e; print(e()); print(jax.config.jax_compilation_cache_dir)"
    )
    if from_env:
        want = str(tmp_path / "cache")
        r = _run(code, {"JAX_COMPILATION_CACHE_DIR": want})
    else:
        want = os.path.join(REPO, ".jax_cache")
        r = _run(code, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want, want]


def test_require_gpu_refuses_cpu():
    import jax

    from tpufusion.utils.device import device_record, require_gpu

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        require_gpu()
    assert device_record()["platform"] == "cpu"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU, and in a directory holding chip_smoke.py and nothing
    else of the repo, the smoke test exits non-zero and prints no
    result."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run([sys.executable, "chip_smoke.py"], cwd=cwd,
             env_extra={"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_main_path_imports_without_flax_or_orbax():
    """predict, serving and checkpointing import with flax and orbax
    blocked (importing a module mapped to None raises ImportError)."""
    code = (
        "import sys\n"
        "for m in ('flax', 'flax.nnx', 'orbax', 'orbax.checkpoint'):\n"
        "    sys.modules[m] = None\n"
        "import tpufusion.predict, tpufusion.serve.pipeline\n"
        "import tpufusion.serve.replay, tpufusion.train.trainer\n"
        "import tpufusion.benchmarks, chip_smoke\n"
        "print('ok')\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.gpu
def test_e2e_gpu_matches_cpu(gpu):
    """The flagship asset's fused e2e step on the card against the same
    jitted step on the CPU at full float32 precision, one batch of 16
    full-width beam scans, held to chip_smoke's tolerances."""
    import jax

    from chip_smoke import check_poses
    from tpufusion.data.synthetic import synthesize_beam_scan_batch
    from tpufusion.models.io import decode_for_resolution, load_detector_asset
    from tpufusion.predict import make_e2e_step

    cfg, variables, meta = load_detector_asset()
    dcfg = decode_for_resolution(cfg.decode, meta, 32768)
    step = make_e2e_step(cfg.model, cfg.range_view, dcfg,
                         head=cfg.model.head)
    pts, _, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(100), 16, 32768
    )
    gp, gf = step(variables, pts, valid)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        rp, rf = step(*jax.device_put((variables, pts, valid), cpu))
    assert np.asarray(rf).any()
    check_poses(gp, gf, rp, rf, "e2e on the card vs cpu")


@pytest.mark.parametrize("name, want", [
    ("jit(step)/decode/vmap(cc)/while/body_pred", "cc"),
    ("jit(step)/fcn/conv_general_dilated", "fcn"),
    ("jit(step)/projection/vmap(sort)", "projection"),
    ("jit(step)/decode/vmap(vmap(vmap()))/while/body/closed_call", "decode"),
    ("jit(step)", None),
    ("", None),
])
def test_profile_scope_of_trace_event(name, want):
    """The trace reducer attributes a device event to the innermost named
    scope of its op path, looking through vmap(...) wrappers."""
    from tpufusion.tools.profile_e2e import _scope

    assert _scope({"name": name, "hlo_op": "fusion.1"}) == want


def test_profile_busy_time_is_interval_union():
    from tpufusion.tools.profile_e2e import busy_and_window

    busy, window = busy_and_window([(10, 20), (0, 5), (15, 30), (40, 41)])
    assert (busy, window) == (5 + 20 + 1, 41)
