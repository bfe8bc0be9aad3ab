"""MFU / throughput profiler (counterpart of
owl_audio_exps_tpu/utils/mfu.py).

FLOPs are computed analytically from the transformer config (matmul
terms, the accounting the JAX package uses); timing is the host clock
around steps that end in a device synchronize; the peak is the card's
dense bf16 rate (``detect_peak_tflops``, from NVIDIA's data sheets,
which give twice these with sparsity): 989 TFLOP/s on an H100 SXM.
"""

from __future__ import annotations

import time

H100_PEAK_TFLOPS = 989.0
# dense bf16 TFLOP/s by device name, the first match taken
PEAK_TFLOPS = (("h100 nvl", 835.0), ("h100 pcie", 756.0),
               ("h100", H100_PEAK_TFLOPS))


def detect_peak_tflops() -> float:
    """The dense bf16 peak of card 0 from ``torch.cuda.get_device_name``
    (an H100 SXM reads "NVIDIA H100 80GB HBM3"); the H100 SXM's where no
    card or no entry matches."""
    import torch
    if not torch.cuda.is_available():
        return H100_PEAK_TFLOPS
    name = torch.cuda.get_device_name(0).lower()
    for key, tflops in PEAK_TFLOPS:
        if key in name:
            return tflops
    return H100_PEAK_TFLOPS


def transformer_flops_per_token(config, seq_len: int) -> float:
    """Forward FLOPs per token for the DiT stack (matmul terms only). The
    MMDiT's and the UViT's count the same: each MMDiT token passes one
    stream's projections and MLP."""
    d = config.d_model
    L = config.n_layers
    # attention projections: qkv (3d^2) + out (d^2); mlp: 2 * 4d^2
    proj = 2 * (4 * d * d + 8 * d * d)
    # attention scores+values: 2 * 2 * seq * d per token, but local layers
    # attend to a window only
    flags_local = sum(1 for i in range(L)
                      if i % (config.get("local_idx", 4) or 4) != 0)
    flags_global = L - flags_local
    tpf = config.tokens_per_frame
    local_ctx = min(seq_len, (config.get("local_window") or 10 ** 9) * tpf)
    global_ctx = min(seq_len, (config.get("global_window") or 10 ** 9) * tpf)
    attn = 4 * d * (flags_local * local_ctx + flags_global * global_ctx) / L
    # modulation (adaln/gate ~ 6 d^2 per layer per frame-token, small) — skip
    return L * (proj + attn)


def training_flops_per_token(config, seq_len: int) -> float:
    return 3.0 * transformer_flops_per_token(config, seq_len)  # fwd + 2x bwd


class MFUProfiler:
    """Training-step timing x FLOP count: seconds per step, tokens/s,
    achieved TFLOP/s and MFU against the card's peak."""

    def __init__(self, config, batch_tokens: int, seq_len: int):
        self.batch_tokens = batch_tokens
        self.peak_tflops = detect_peak_tflops()
        self.flops_per_step = \
            training_flops_per_token(config, seq_len) * batch_tokens
        self._t0 = None
        self._steps = 0
        self._elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int = 1):
        if self._t0 is None:
            raise RuntimeError("MFUProfiler.stop() without start()")
        self._elapsed += time.perf_counter() - self._t0
        self._steps += n_steps
        self._t0 = None

    def report(self, reset: bool = True) -> dict:
        """Window-local stats since the previous report."""
        if self._steps == 0 or self._elapsed == 0:
            return {}
        sec_per_step = self._elapsed / self._steps
        tflops = self.flops_per_step / sec_per_step / 1e12
        if reset:
            self._steps = 0
            self._elapsed = 0.0
        return {
            "perf/sec_per_step": sec_per_step,
            "perf/tokens_per_sec": self.batch_tokens / sec_per_step,
            "perf/achieved_tflops": tflops,
            "perf/mfu": tflops / self.peak_tflops,
        }
