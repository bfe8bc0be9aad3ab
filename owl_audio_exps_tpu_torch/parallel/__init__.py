"""Multi-process training (counterpart of owl_audio_exps_tpu/parallel/):
the process group (dist.py), the data x seq mesh (mesh.py) and context
parallelism over the seq axis (context.py)."""
