"""Share of the optimizer's parameter updates that took the grouped path
(list operations a group of tensors at a time) rather than the
per-tensor loop: the program's always-on counters ``grouped`` and
``looped`` of ``owl_audio_exps_tpu_torch/muon.py`` since import, read
at the end of the run; in %. None where the program has no such
counters or counted nothing."""

import sys


def read(ctx):
    mod = sys.modules.get("owl_audio_exps_tpu_torch.muon")
    grouped = getattr(mod, "grouped", 0)
    looped = getattr(mod, "looped", 0)
    if grouped + looped == 0:
        return None
    return 100.0 * grouped / (grouped + looped)
