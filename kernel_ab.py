"""A/B of the port's attention kernels between source trees, on one card.

Usage (from the repository root, on a machine with one NVIDIA GPU):

    git archive <parent> | tar -x -C build/parent
    python3 kernel_ab.py parent=build/parent change=. \
        [--doc-order-off noorder]

Each tree runs in its own process, which builds that tree's kernels
(owl_audio_exps_tpu_torch/csrc, into <tree>/build/kernels) and times them
with CUDA events (2 warm-up calls, then the mean of 10) on the same seeded
bf16 inputs: K1 without documents (L 16,384, tpf 64, causal, global and
window 16: forward with the logsumexp, dq, dkv), K4 (L 24,576, causal and
unmasked: forward, dq, dkv), K2 (L 16,384, window 16, logit bound 8:
forward, backward) and K5 (L 24,960, tpf 65, plan (520, 2), bound 8),
B 1, H 24, Dh 64; and, where the tree has K1's document walk, K1 with
documents (one document at L 16,384, the same work as document-free K1;
two documents at L 16,384 and 98,304, 24 short ones at L 16,384, two at
H 40), each on one summary made beforehand. The trees
run in the order given and then in reverse (a, b, b, a), so that a
drift of the card's clocks shows. ``--doc-order-off NAME`` adds a copy
of the last tree given with K1's document tiles taken in row order
instead of the summary's order by work (build/NAME), run after the
others and before their reverse. Prints the card, each run's times, and one table line a
kernel: the runs' times in order.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

CASES_NOTE = "B 1, H 24 (H 40 where named), Dh 64, bf16; ms"


def worker(tree: str, tag: str):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from owl_audio_exps_tpu_torch.ops import _build, band, band2, splash
    _build.build_all()
    dev = torch.device("cuda", 0)

    def ms(fn, iters=10):
        for _ in range(2):
            fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def inputs(L, H=24):
        g = torch.Generator(device=dev).manual_seed(0)
        return [torch.randn(1, H, L, 64, generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(4)]

    res = {}

    def k1(name, L, tpf, window, doc=None, H=24):
        q, k, v, g = inputs(L, H)
        if doc is not None:
            doc = splash.doc_tiles_for(doc, q, tpf, window, True)
        args = (tpf, window, True, doc)
        f = ms(lambda: splash.frame_attention_cuda(q, k, v, *args,
                                                   return_lse=True))
        out, lse = splash.frame_attention_cuda(q, k, v, *args,
                                               return_lse=True)
        dq = ms(lambda: splash.frame_attention_bwd_dq_cuda(
            q, k, v, out, lse, g, *args))
        _, delta = splash.frame_attention_bwd_dq_cuda(q, k, v, out, lse, g,
                                                      *args)
        res[name] = [f, dq, ms(lambda: splash.frame_attention_bwd_dkv_cuda(
            q, k, v, out, lse, delta, g, *args))]

    k1("K1_L16384_global", 16384, 64, None)
    k1("K1_L16384_w16", 16384, 64, 16)
    for causal in (False, True):
        q, k, v, g = inputs(24576)
        f = ms(lambda: splash.splash_attention_lse_cuda(q, k, v, 64, causal))
        out, lse = splash.splash_attention_lse_cuda(q, k, v, 64, causal)
        delta = splash.ring_delta(out, g, None)
        res[f"K4_L24576_{'causal' if causal else 'full'}"] = [
            f, ms(lambda: splash.splash_attention_lse_bwd_dq_cuda(
                q, k, v, lse, delta, g, 64, causal)),
            ms(lambda: splash.splash_attention_lse_bwd_dkv_cuda(
                q, k, v, lse, delta, g, 64, causal))]
    q, k, v, g = inputs(16384)
    out, lse = band.band_attention_cuda(q, k, v, 64, 16, 8.0)
    res["K2_L16384_w16_bound8"] = [
        ms(lambda: band.band_attention_cuda(q, k, v, 64, 16, 8.0)),
        ms(lambda: band.band_attention_bwd_cuda(q, k, v, out, lse, g, 64, 16,
                                                8.0))]
    q, k, v, g = inputs(24960)
    out, lse = band2.band2_attention_cuda(q, k, v, 65, 16, 520, 2, 8.0)
    res["K5_L24960_520x2_bound8"] = [
        ms(lambda: band2.band2_attention_cuda(q, k, v, 65, 16, 520, 2, 8.0)),
        ms(lambda: band2.band2_attention_bwd_cuda(q, k, v, out, lse, g, 65,
                                                  16, 520, 2, 8.0))]
    if hasattr(splash, "doc_tiles_for"):
        def two(nf):
            return (torch.arange(nf, device=dev) >= nf // 3).int()[None]
        short = torch.repeat_interleave(torch.arange(24), torch.tensor(
            [8] * 16 + [16] * 8)).int()[None].to(dev)
        # one document: the same work as document-free K1
        k1("K1doc_L16384_one", 16384, 64, None,
           torch.zeros(1, 256, dtype=torch.int32, device=dev))
        k1("K1doc_L16384_two", 16384, 64, None, two(256))
        k1("K1doc_L16384_24short", 16384, 64, None, short)
        k1("K1doc_L16384_H40_two", 16384, 64, None, two(256), H=40)
        k1("K1doc_L98304_two", 98304, 64, None, two(1536))
    print("RESULT " + json.dumps({"tag": tag, "ms": res}), flush=True)


def doc_order_off(src: str, name: str) -> str:
    """A copy of tree ``src``'s package under build/<name> whose K1 kernels
    take their document tiles in row order (the document-free grid's)."""
    dst = os.path.join("build", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(src, "owl_audio_exps_tpu_torch"),
                    os.path.join(dst, "owl_audio_exps_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "owl_audio_exps_tpu_torch", "csrc",
                        "frame_attention.cu")
    with open(path) as f:
        text = f.read()
    for old, new in (("doc_tile_of(p, b, false)", "query_tile(p, kRows)"),
                     ("doc_tile_of(p, b, true)",
                      "(int)(blockIdx.x * kRows)")):
        if old not in text:
            sys.exit(f"no '{old}' in {path}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return dst


def main():
    if sys.argv[1:2] == ["--worker"]:
        return worker(sys.argv[2], sys.argv[3])
    args, off = sys.argv[1:], None
    if "--doc-order-off" in args:
        i = args.index("--doc-order-off")
        off = args[i + 1]
        del args[i:i + 2]
    trees = [a.split("=", 1) for a in args]
    if not trees or any(len(t) != 2 for t in trees):
        sys.exit("usage: kernel_ab.py NAME=TREE [NAME=TREE ...] "
                 "[--doc-order-off NAME]")
    if off:
        trees.append([off, doc_order_off(trees[-1][1], off)])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    runs = []
    for tag, tree in trees + trees[::-1]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", tree, tag], capture_output=True,
                           text=True)
        line = [s for s in r.stdout.splitlines() if s.startswith("RESULT ")]
        if r.returncode or not line:
            print(r.stdout[-3000:], r.stderr[-3000:], flush=True)
            sys.exit(f"{tag} ({tree}) failed: exit {r.returncode}")
        runs.append(json.loads(line[0][len("RESULT "):]))
        print(line[0], flush=True)
    print(f"[ab] {CASES_NOTE}; runs in order "
          f"{' '.join(r['tag'] for r in runs)}", flush=True)
    for name in sorted({n for r in runs for n in r["ms"]}):
        print(f"[ab] {name}: " + " | ".join(
            f"{r['tag']} " + " ".join(f"{x:.4f}" for x in r["ms"][name])
            for r in runs if name in r["ms"]), flush=True)


if __name__ == "__main__":
    main()
