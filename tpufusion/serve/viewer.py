"""Live browser-based viewer — the headless replacement for the
reference's pyglet windows.

The reference popped interactive pyglet windows per topic during bag
extraction and replay (`modules/lidar/process/extract_rosbag.py:114-120,
207-213`, `modules/video/reader.py`), which cannot exist on a headless
accelerator host. This equivalent streams the same named "windows"
(range view, BEV, class mask, camera) to any browser over HTTP:
`LiveViewer.push(name, frame)` updates the latest frame for a window and
every connected browser sees it via an MJPEG multipart stream — the same
update-latest semantics as the pyglet `get_window(topic)` pattern, with
no client-side code.

Usage:
    viewer = LiveViewer(port=8642)
    viewer.start()
    viewer.push("range_view", rgb_u8)   # any (H, W[, 3]) uint8/float
    ...
    viewer.stop()

or end-to-end: `python -m tpufusion.cli view <dataset_dir>` replays an
extracted dataset through projection(+optional checkpoint inference) and
streams the renders.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_INDEX = """<!doctype html>
<html><head><title>tpufusion live</title>
<style>
 body {{ background: #111; color: #ddd; font-family: monospace; }}
 .win {{ margin: 12px; display: inline-block; vertical-align: top; }}
 img {{ max-width: 96vw; image-rendering: pixelated; border: 1px solid #444; }}
 h3 {{ margin: 2px 0; }}
</style></head><body>
<h2>tpufusion live viewer</h2>
{windows}
</body></html>"""


def _encode_jpeg(frame: np.ndarray) -> bytes:
    import cv2

    if frame.dtype != np.uint8:
        lo, hi = float(np.min(frame)), float(np.max(frame))
        frame = (
            np.zeros_like(frame, np.uint8)
            if hi <= lo
            else ((frame - lo) / (hi - lo) * 255).astype(np.uint8)
        )
    ok, buf = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, 88])
    if not ok:
        raise ValueError(f"unencodable frame shape {frame.shape}")
    return bytes(buf)


class LiveViewer:
    """Thread-backed HTTP server streaming named frame windows (MJPEG)."""

    def __init__(self, port: int = 8642, host: str = "0.0.0.0"):
        self.host, self.port = host, port
        self._frames: dict[str, bytes] = {}
        self._seq: dict[str, int] = {}
        self._cond = threading.Condition()
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- producer side ----------------------------------------------------
    def push(self, name: str, frame: np.ndarray) -> None:
        """Update window `name` with a (H, W[, 3]) array (any dtype)."""
        data = _encode_jpeg(np.asarray(frame))
        with self._cond:
            self._frames[name] = data
            self._seq[name] = self._seq.get(name, 0) + 1
            self._cond.notify_all()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "LiveViewer":
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    return self._index()
                if self.path.startswith("/frame/"):
                    return self._frame(self.path[len("/frame/"):])
                if self.path.startswith("/stream/"):
                    return self._stream(self.path[len("/stream/"):])
                self.send_error(404)

            def _index(self):
                with viewer._cond:
                    names = sorted(viewer._frames) or ["(no frames yet)"]
                wins = "\n".join(
                    f'<div class="win"><h3>{n}</h3>'
                    f'<img src="/stream/{n}"></div>'
                    if not n.startswith("(")
                    else f"<p>{n}</p>"
                    for n in names
                )
                body = _INDEX.format(windows=wins).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _frame(self, name):
                with viewer._cond:
                    data = viewer._frames.get(name)
                if data is None:
                    return self.send_error(404, f"no window {name!r}")
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _stream(self, name):
                with viewer._cond:
                    known = name in viewer._frames
                if not known:
                    # match /frame: an unknown window 404s instead of
                    # pinning a server thread on a forever-empty stream
                    return self.send_error(404, f"no window {name!r}")
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                last = -1
                try:
                    while True:
                        with viewer._cond:
                            viewer._cond.wait_for(
                                lambda: viewer._seq.get(name, 0) != last,
                                timeout=1.0,
                            )
                            data = viewer._frames.get(name)
                            last = viewer._seq.get(name, 0)
                        if data is None:
                            continue
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(data)}\r\n\r\n".encode()
                        )
                        self.wfile.write(data)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # browser went away

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def view_dataset(
    path: str,
    checkpoint: str | None = None,
    port: int = 8642,
    rate_hz: float = 10.0,
    loop: bool = False,
) -> None:
    """Replay a dataset through the pipeline and stream range-view
    (+ BEV for raw point files, + class-mask with a checkpoint) renders —
    the `rosplayback` + pyglet-viewers workflow, in a browser.

    `path` is either an extracted dataset dir (lidar_frames.npz of
    projected range views, cli extract's output) or a raw .npz with a
    `points` (F, N, 4) array (cli extract's input), which also gets the
    BEV window."""
    import jax
    import jax.numpy as jnp

    from tpufusion.config import DEFAULT, BevSpec
    from tpufusion.geometry.bev import bev_rasterize
    from tpufusion.geometry.range_view import range_view_project
    from tpufusion.models.fcn import apply_fcn, init_fcn
    from tpufusion.tools.visualize import (
        render_bev,
        render_class_mask,
        render_range_view,
    )

    spec = DEFAULT.range_view
    bev_spec = BevSpec()
    points = None
    if path.endswith(".npz"):
        points = np.load(path)["points"]
        n_frames = len(points)
    else:
        from tpufusion.data.etl import load_extracted

        images = load_extracted(path)["images"]
        n_frames = len(images)

    fwd = None
    if checkpoint is not None:
        from tpufusion.train.checkpoint import CheckpointManager

        _, variables, _ = CheckpointManager(checkpoint).restore(
            init_fcn(DEFAULT.model, jax.random.PRNGKey(0), in_channels=3)
        )

        @jax.jit
        def fwd(img):
            preds, _ = apply_fcn(DEFAULT.model, variables, img[None])
            return jax.nn.softmax(preds[0, ..., :2])[..., 1]

    viewer = LiveViewer(port=port).start()
    print(f"live viewer: http://localhost:{viewer.port}/  "
          f"({n_frames} frames at {rate_hz} Hz"
          + (", looping" if loop else "") + ")", flush=True)
    try:
        while True:
            for i in range(n_frames):
                t0 = time.time()
                if points is not None:
                    pts = jnp.asarray(points[i], jnp.float32)
                    img = np.asarray(range_view_project(pts, spec))
                    viewer.push(
                        "bev",
                        render_bev(
                            np.asarray(bev_rasterize(pts, bev_spec)),
                            spec=bev_spec,
                        ),
                    )
                else:
                    img = np.asarray(images[i])
                viewer.push("range_view", render_range_view(img, spec=spec))
                if fwd is not None:
                    viewer.push(
                        "class_mask",
                        render_class_mask(np.asarray(fwd(jnp.asarray(img)))),
                    )
                dt = 1.0 / rate_hz - (time.time() - t0)
                if dt > 0:
                    time.sleep(dt)
            if not loop:
                break
    except KeyboardInterrupt:
        pass
    finally:
        viewer.stop()
