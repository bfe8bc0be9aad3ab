"""Interactive game loop: keyboard and mouse -> a streaming pipeline ->
display (counterpart of inference/game_cv.py).

``GameCV`` owns the input mapping, the 60 FPS loop and its stats against a
small display-backend interface; ``X11Backend`` implements it with
python-xlib (imported in its constructor), ``HeadlessBackend`` drives the
pipeline without a display. Keymap W A S D LSHIFT SPACE R F E + LMB / RMB
into the 11-button vector; y / u reset or restart the buffers, o / i
change the sampling steps, Escape / q quit. Every second the loop prints
``fps=<ticks in that second> model_p50=<median tick ms>``.

Run headless on the card, decoding each tick through the DC-AE decoder:

    python -m owl_audio_exps_tpu_torch.inference.game_cv --config_path configs/causvid.yml --headless --vae dcae --ticks 30

The model comes from ``--ckpt_path`` (``from_pretrained``) or seeded
weights, on ``--device`` (the card unless ``cpu``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

KEYBINDS = ["W", "A", "S", "D", "LSHIFT", "SPACE", "R", "F", "E",
            "LMB", "RMB"]

# key name -> slot in the 11-button vector
KEYMAP = {
    "w": 0, "a": 1, "s": 2, "d": 3, "shift_l": 4, "space": 5,
    "r": 6, "f": 7, "e": 8,
}
# X11 pointer buttons: 1 = LMB -> 9, 3 = RMB -> 10
BUTTONMAP = {1: 9, 3: 10}


class HeadlessBackend:
    """No display: no events, no blit; drives the pipeline loop for its
    FPS and latency stats on servers."""

    def poll_events(self) -> List[tuple]:
        return []

    def query_pointer(self) -> Tuple[int, int]:
        return (0, 0)

    def blit(self, frame: np.ndarray):
        pass

    def close(self):
        pass


class X11Backend:
    """A python-xlib window; events normalised to ("key", name, pressed)
    / ("button", n, pressed) / ("close",)."""

    def __init__(self, width: int = 640, height: int = 360, display=None):
        import Xlib.display
        from Xlib import X, Xatom

        self._X = X
        self.width, self.height = width, height
        self.disp = display or Xlib.display.Display()
        screen = self.disp.screen()
        self.win = screen.root.create_window(
            0, 0, width, height, 0,
            screen.root_depth, X.InputOutput, X.CopyFromParent,
            background_pixel=screen.black_pixel,
            event_mask=(X.ExposureMask | X.KeyPressMask | X.KeyReleaseMask
                        | X.ButtonPressMask | X.ButtonReleaseMask
                        | X.PointerMotionMask | X.StructureNotifyMask))
        self.win.set_wm_name("owl game - X11")
        self.gc = self.win.create_gc()
        self.win.map()
        self.WM_DELETE = self.disp.intern_atom("WM_DELETE_WINDOW")
        self.win.change_property(self.disp.intern_atom("WM_PROTOCOLS"),
                                 Xatom.ATOM, 32, [self.WM_DELETE])

    def poll_events(self) -> List[tuple]:
        from Xlib import X, XK
        out = []
        while self.disp.pending_events():
            ev = self.disp.next_event()
            if ev.type == X.ClientMessage and ev.data[0] == self.WM_DELETE:
                out.append(("close",))
            elif ev.type in (X.KeyPress, X.KeyRelease):
                keysym = self.disp.keycode_to_keysym(ev.detail, 0)
                name = XK.keysym_to_string(keysym)
                if name is None:  # non-printable (Shift_L, space, Escape)
                    for cand in ("Shift_L", "space", "Escape"):
                        if keysym == XK.string_to_keysym(cand):
                            name = cand
                            break
                if name is not None:
                    out.append(("key", name.lower(),
                                ev.type == X.KeyPress))
            elif ev.type in (X.ButtonPress, X.ButtonRelease):
                out.append(("button", ev.detail,
                            ev.type == X.ButtonPress))
        return out

    def query_pointer(self) -> Tuple[int, int]:
        ptr = self.win.query_pointer()
        return (ptr.win_x, ptr.win_y)

    def blit(self, frame: np.ndarray):
        """frame [H, W, 3] -> 0x00RRGGBB pixels, put in chunks of 64
        rows."""
        X = self._X
        f = frame.astype(np.uint32)
        packed = (f[:, :, 0] << 16) | (f[:, :, 1] << 8) | f[:, :, 2]
        data = packed.astype("<u4").tobytes()
        stride = self.width * 4
        chunk_rows = 64
        for y in range(0, self.height, chunk_rows):
            h = min(chunk_rows, self.height - y)
            off = y * stride
            self.win.put_image(self.gc, 0, y, self.width, h,
                               X.ZPixmap, 24, 0,
                               data[off: off + h * stride])
        self.disp.flush()

    def close(self):
        self.disp.close()


def make_backend(width: int = 640, height: int = 360, headless=None):
    """X11 when python-xlib and $DISPLAY exist (or ``headless`` is
    False), else headless."""
    if headless is None:
        import os
        try:
            import Xlib.display  # noqa: F401
            headless = not bool(os.environ.get("DISPLAY"))
        except ImportError:
            headless = True
    if headless:
        return HeadlessBackend()
    return X11Backend(width, height)


class GameCV:
    """Input mapping + 60 FPS loop + stats (backend-agnostic)."""

    def __init__(self, pipeline, backend=None, fps: int = 60,
                 mouse_scale: float = 0.01, headless: Optional[bool] = None):
        self.pipeline = pipeline
        self.backend = backend or make_backend(headless=headless)
        self.fps = fps
        self.mouse_scale = mouse_scale
        self.button_state = np.zeros(len(KEYBINDS), dtype=bool)
        self.last_mouse_pos: Optional[Tuple[int, int]] = None
        self.running = True

    # ------------------------------------------------------------ events
    def handle_event(self, ev: tuple):
        kind = ev[0]
        if kind == "close":
            self.running = False
        elif kind == "key":
            _, name, pressed = ev
            if pressed and name in ("escape", "q"):
                self.running = False
                return
            if pressed:  # the pipeline's control keys
                if name == "y" and hasattr(self.pipeline, "init_buffers"):
                    self.pipeline.init_buffers()
                elif name == "u" and hasattr(self.pipeline,
                                             "restart_from_buffer"):
                    self.pipeline.restart_from_buffer()
                elif name == "o" and hasattr(self.pipeline,
                                             "up_sampling_steps"):
                    self.pipeline.up_sampling_steps()
                elif name == "i" and hasattr(self.pipeline,
                                             "down_sampling_steps"):
                    self.pipeline.down_sampling_steps()
            if name in KEYMAP:
                self.button_state[KEYMAP[name]] = pressed
        elif kind == "button":
            _, n, pressed = ev
            if n in BUTTONMAP:
                self.button_state[BUTTONMAP[n]] = pressed

    def poll_events(self):
        for ev in self.backend.poll_events():
            self.handle_event(ev)

    def mouse_delta(self) -> np.ndarray:
        """The pointer's move since the last poll, scaled and clamped to
        [-1, 1]."""
        pos = self.backend.query_pointer()
        if self.last_mouse_pos is None:
            self.last_mouse_pos = pos
            return np.zeros(2, dtype=np.float32)
        dx = (pos[0] - self.last_mouse_pos[0]) * self.mouse_scale
        dy = (pos[1] - self.last_mouse_pos[1]) * self.mouse_scale
        self.last_mouse_pos = pos
        return np.clip(np.asarray([dx, dy], np.float32), -1.0, 1.0)

    # -------------------------------------------------------------- loop
    def run(self, max_ticks: Optional[int] = None) -> int:
        frame_budget = 1.0 / self.fps
        tick = 0
        stats_t0 = time.perf_counter()
        frames_in_sec = 0
        model_times = []

        while self.running and (max_ticks is None or tick < max_ticks):
            t_start = time.perf_counter()
            self.poll_events()
            if not self.running:
                break
            mouse = self.mouse_delta()

            frame, _audio, model_time = self.pipeline(
                mouse, self.button_state.astype(np.float32))
            model_times.append(model_time)
            if frame is not None:
                if hasattr(frame, "cpu"):   # a tensor on the device
                    frame = frame.float().cpu().numpy()
                self.backend.blit(np.asarray(frame))

            tick += 1
            frames_in_sec += 1
            now = time.perf_counter()
            if now - stats_t0 >= 1.0:
                p50 = float(np.median(model_times)) if model_times else 0.0
                steps = getattr(self.pipeline, "sampling_steps", None)
                print(f"fps={frames_in_sec} model_p50={p50 * 1e3:.1f}ms"
                      + (f" steps={steps}" if steps is not None else ""),
                      flush=True)
                stats_t0, frames_in_sec, model_times = now, 0, []

            remaining = frame_budget - (now - t_start)
            if remaining > 0:
                time.sleep(remaining)
        self.backend.close()
        return tick


def main(argv=None) -> int:
    """Build the model from a config (``--ckpt_path``, else seeded
    weights), wrap it in a serve pipeline (``--pipeline``), decode through
    ``--vae`` when given, and run the loop: X11 when a display is
    available, headless stats otherwise. Returns the ticks run."""
    import argparse

    import torch

    from .. import from_pretrained
    from ..models import get_core_cls
    from ..utils.checkpoints import unwrap_core
    from ..utils.device import resolve_device
    from .pipeline import (AVCachedStreamingPipeline,
                           CachedStreamingPipeline, CausvidPipeline)

    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--ckpt_path", default=None)
    parser.add_argument("--pipeline", default="cached",
                        choices=["cached", "av_cached", "window"])
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--window_frames", type=int, default=120)
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--ticks", type=int, default=None,
                        help="stop after N ticks (default: run until quit)")
    parser.add_argument("--headless", action="store_true")
    parser.add_argument("--vae", default=None,
                        choices=[None, "dcae", "pixel_shuffle"],
                        help="decode frames to pixels through this video "
                             "VAE")
    parser.add_argument("--vae_ckpt", default=None,
                        help="torch state_dict for the video VAE decoder")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg, params = from_pretrained(args.config_path, args.ckpt_path)
    m = cfg.model
    core = get_core_cls(m.model_id)(m, dtype=torch.bfloat16, device=device,
                                    seed=0)
    if params is None:
        print("no checkpoint: random-init smoke run", flush=True)
    else:
        core.load_state_dict(unwrap_core(params), strict=True)
    core = core.to(torch.bfloat16).eval()
    rs = np.random.RandomState(0)
    n_ctx = 8

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device).to(
            torch.bfloat16)

    ctx = tensor(rs.randn(1, n_ctx, m.channels, m.sample_size,
                          m.sample_size))
    mouse = tensor(np.zeros((1, n_ctx, 2)))
    btn = tensor(np.zeros((1, n_ctx, m.n_buttons)))
    has_audio = m.model_id in ("game_rft_audio", "game_mft_audio")
    aud = tensor(rs.randn(1, n_ctx, m.audio_channels)) if has_audio \
        else None

    frame_decode_fn = None
    if args.vae:
        from ..utils.owl_vae_bridge import (get_decoder_only,
                                            make_batched_decode_fn)
        dec = get_decoder_only(args.vae, ckpt_path=args.vae_ckpt,
                               latent_channels=m.channels, device=device)
        frame_decode_fn = make_batched_decode_fn(dec, batch_size=1)

    kind = args.pipeline
    kw = dict(window_frames=args.window_frames, sampling_steps=args.steps,
              frame_decode_fn=frame_decode_fn, device=device)
    if kind == "av_cached" or (kind == "cached" and has_audio):
        pipe = AVCachedStreamingPipeline(core, m, **kw)
        pipe.prime(ctx, aud, mouse, btn)
    elif kind == "cached":
        pipe = CachedStreamingPipeline(core, m, **kw)
        pipe.prime(ctx, mouse, btn)
    else:
        pipe = CausvidPipeline(core, m, window_length=60,
                               sampling_steps=args.steps,
                               frame_decode_fn=frame_decode_fn, device=device)

    loop = GameCV(pipe, fps=args.fps,
                  headless=True if args.headless else None)
    return loop.run(max_ticks=args.ticks)


if __name__ == "__main__":
    main()
