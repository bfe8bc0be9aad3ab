"""owl_audio_exps_tpu_torch — PyTorch and CUDA port of owl_audio_exps_tpu for
NVIDIA Hopper. The JAX package beside it is the reference: module paths
mirror it, and every TPU kernel on a ported path is a hand-written CUDA
kernel under csrc/ with a plain PyTorch version beside its wrapper.
"""

__version__ = "0.1.0"

from .configs import Config, ConfigNode, transformer_config  # noqa: F401


def from_pretrained(cfg_path: str, ckpt_path: str = None,
                    return_decoder: bool = False, device="cuda"):
    """(config, state_dict or None[, frame decoder]) from a YAML and a
    local checkpoint (counterpart of the JAX package's ``from_pretrained``;
    nothing is downloaded). A ``.pt`` in the owl_wms layout is the port's
    own state_dict layout and loads as it is (the EMA of a {"model",
    "ema"} checkpoint, wrapper prefixes stripped), as does a port
    checkpoint or export (utils/checkpoints.py ``load_torch_file``). With
    ``return_decoder`` the config's video decoder (``vae_id``,
    ``vae_cfg_path``, ``vae_ckpt_path``) comes from the VAE bridge's
    ``get_decoder_only`` on ``device``."""
    cfg = Config.from_yaml(cfg_path)
    params = None
    if ckpt_path is not None:
        from .utils.checkpoints import load_torch_file
        params = load_torch_file(ckpt_path)
    if return_decoder:
        from .utils.owl_vae_bridge import get_decoder_only
        decoder = get_decoder_only(cfg.train.vae_id,
                                   cfg.train.get("vae_cfg_path"),
                                   cfg.train.get("vae_ckpt_path"),
                                   latent_channels=cfg.model.channels,
                                   device=device)
        return cfg, params, decoder
    return cfg, params
