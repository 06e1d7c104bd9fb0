"""Auxiliary-subsystem tests (SURVEY.md §5): determinism, staging-queue
stress (the only racy component, §5.2), synthetic stream source, batch
logging."""

import io
import json
import time

import numpy as np

from refimpl.synthetic import moving_disk_clip
from tpuva.export import write_tracks_hdf5
from tpuva.graph.config import (
    BackgroundConfig,
    PipelineConfig,
    SegmentConfig,
    TrackConfig,
)
from tpuva.graph.pipeline import process_clip
from tpuva.io import BatchStager, VideoMemory
from tpuva.io.synthetic import SyntheticVideo
from tpuva.utils import BatchLogger, display_progress

CFG = PipelineConfig(
    background=BackgroundConfig(alpha=0.03),
    segment=SegmentConfig(threshold=40.0, min_area=20, max_blobs=4),
    track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
    batch=8,
)


def test_determinism_identical_hdf5_bytes(tmp_path):
    """Same input -> identical HDF5 bytes across independent runs
    (SURVEY.md §4.2 determinism)."""
    clip, _, plate = moving_disk_clip(h=96, w=128, frames=32, radius=8)
    paths = []
    for i in range(2):
        rows, _, _ = process_clip(clip, CFG, background0=plate)
        p = str(tmp_path / f"run{i}.h5")
        write_tracks_hdf5(p, rows)
        paths.append(p)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_staging_queue_stress_slow_consumer():
    """Decode faster than consume: queue depth must stay bounded and no
    frame may be lost or reordered (SURVEY.md §5.2)."""
    clip = np.arange(40, dtype=np.uint8)[:, None, None] * np.ones(
        (40, 16, 16), np.uint8
    )
    stager = BatchStager(VideoMemory(clip), batch=4, queue_depth=2)
    seen = []
    for n, dev in stager:
        time.sleep(0.01)  # slow consumer
        assert stager.depth <= 2
        seen.append(np.asarray(dev)[:n])
    got = np.concatenate(seen)
    np.testing.assert_array_equal(got, clip)


def test_staging_error_propagates():
    from tpuva.io import VideoBase

    class Bad(VideoMemory):
        # force the per-frame path (VideoMemory.iter_batches slices the
        # array directly and would bypass get_frame)
        iter_batches = VideoBase.iter_batches

        def get_frame(self, index):
            if index == 7:
                raise IOError("boom")
            return super().get_frame(index)

    clip = np.zeros((12, 8, 8), np.uint8)
    stager = BatchStager(Bad(clip), batch=4)
    try:
        for _ in stager:
            pass
        assert False, "expected IOError"
    except IOError as e:
        assert "boom" in str(e)


def test_synthetic_video_random_access_consistency():
    v = SyntheticVideo(h=60, w=80, frames=100, n_blobs=2, radius=6, seed=3)
    f10 = v.get_frame(10)
    seq = None
    for i, f in enumerate(v):
        if i == 10:
            seq = f
            break
    np.testing.assert_array_equal(f10, seq)
    # blobs stay in bounds over a long horizon
    pos = v.positions(99_999 if v.frame_count > 99_999 else 99)
    w, h = v.size
    assert (pos[:, 0] > 0).all() and (pos[:, 0] < w).all()
    assert (pos[:, 1] > 0).all() and (pos[:, 1] < h).all()


def test_batch_logger_and_progress():
    buf = io.StringIO()
    log = BatchLogger(out=buf, every=0.0)
    log.log(8, queue=2)
    log.log(8, queue=1)
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    assert lines[-1]["frames"] == 16 and "fps" in lines[-1]
    buf2 = io.StringIO()
    out = list(display_progress(range(5), out=buf2, every=0.0))
    assert out == list(range(5))
    assert "5/5" in buf2.getvalue()


def test_library_import_does_not_initialize_backend():
    """Importing any tpuva layer must not touch the JAX backend: a
    module-level jnp constant once made `import tpuva.app` initialize
    the device at import time — which hangs when the accelerator is
    unreachable. An
    unsatisfiable JAX_PLATFORMS makes any backend init in the subprocess
    raise, so a clean import proves purity."""
    import subprocess, sys as _sys, os as _os

    env = dict(_os.environ, JAX_PLATFORMS="no_such_platform_xyz")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [_sys.executable, "-c",
         "import tpuva, tpuva.app, tpuva.graph.streaming, tpuva.dist, "
         "tpuva.track.table, tpuva.filters, tpuva.analysis, tpuva.compose; "
         "print('IMPORT_CLEAN')"],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    )
    assert "IMPORT_CLEAN" in r.stdout, (r.stdout, r.stderr[-800:])


def test_compilation_cache_dir_segregation(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache goes to the one fixed
    path <repo>/.jax_cache: the path is part of each cache key, so it is
    never built from a temp name, a process id or the time."""
    import os

    import jax

    from tpuva.utils import enable_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        enable_compilation_cache()
        first = jax.config.jax_compilation_cache_dir
        enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == first
        assert first == os.path.join(repo, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compilation_cache_honours_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no directory
    of its own: a process that enables the cache and compiles writes its
    entries there. Subprocess, because jax reads the variable at import."""
    import os
    import subprocess
    import sys

    code = (
        "import jax, jax.numpy as jnp\n"
        "from tpuva.utils import enable_compilation_cache\n"
        "enable_compilation_cache()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(8)).block_until_ready()\n"
    )
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        JAX_COMPILATION_CACHE_DIR=str(tmp_path),
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
    )
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.stdout.strip() == str(tmp_path), out.stderr[-800:]
    assert any(tmp_path.iterdir()), "no cache entry written"


def test_transfer_guard_blocks_implicit_hot_loop_transfer():
    """SURVEY.md §5.8 discipline: the streamed dispatch loop runs under
    jax.transfer_guard('disallow'); an accidental implicit host->device
    transfer sneaking into the hot loop must raise, not silently
    serialize dispatch."""
    import jax
    import pytest

    from tpuva.graph.streaming import StreamingPipeline

    class Leaky(StreamingPipeline):
        def _step(self, cfg, carry, dev_batch):
            # the regression class the guard exists for: a host ndarray
            # operand entering a jitted call inside the hot loop
            jax.jit(lambda a: a + 1)(np.zeros(4, np.float32))
            return super()._step(cfg, carry, dev_batch)

    clip, _, plate = moving_disk_clip(h=48, w=64, frames=16, radius=6)
    with pytest.raises(Exception, match="Disallowed host-to-device"):
        Leaky(CFG).run(VideoMemory(clip), background0=plate)


def test_transfer_guard_escape_hatch(monkeypatch):
    """TPUVA_NO_TRANSFER_GUARD=1 disables the guard (diagnostic mode) —
    which also proves the guard is what raises in the test above."""
    import jax

    from tpuva.graph.streaming import StreamingPipeline

    class Leaky(StreamingPipeline):
        def _step(self, cfg, carry, dev_batch):
            jax.jit(lambda a: a + 1)(np.zeros(4, np.float32))
            return super()._step(cfg, carry, dev_batch)

    monkeypatch.setenv("TPUVA_NO_TRANSFER_GUARD", "1")
    clip, _, plate = moving_disk_clip(h=48, w=64, frames=16, radius=6)
    rows = Leaky(CFG).run(VideoMemory(clip), background0=plate)
    assert len(rows) == 16


def test_guarded_streaming_with_checkpoints(tmp_path):
    """The production path (checkpoints + async drainer) is clean under
    the guard: every intended crossing is explicit."""
    from tpuva.graph.streaming import StreamingPipeline

    clip, _, plate = moving_disk_clip(h=48, w=64, frames=32, radius=6)
    sp = StreamingPipeline(
        CFG, checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=2
    )
    rows = sp.run(VideoMemory(clip), background0=plate)
    assert len(rows) == 32


def test_debug_nans_dev_flag():
    """TPUVA_DEBUG_NANS=1 (SURVEY.md §5.2) wires jax_debug_nans at import:
    the first NaN-producing op raises at its source. Subprocess because
    the flag is applied at package import."""
    import subprocess
    import sys
    import os as _os

    code = (
        "import os\n"
        "os.environ['JAX_PLATFORMS']='cpu'\n"
        "import jax\n"
        "jax.config.update('jax_platforms','cpu')\n"
        "import tpuva\n"
        "assert jax.config.jax_debug_nans\n"
        "import jax.numpy as jnp\n"
        "try:\n"
        "    jax.jit(lambda x: x / x)(jnp.zeros(3)).block_until_ready()\n"
        "except FloatingPointError:\n"
        "    print('NAN_RAISED')\n"
    )
    env = dict(_os.environ, TPUVA_DEBUG_NANS="1", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, env=env, cwd=_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))),
    )
    assert "NAN_RAISED" in out.stdout, out.stderr[-800:]
