"""Open-schema configuration system (counterpart of owl_audio_exps_tpu/configs.py).

The reference config system (reference: owl_wms/configs.py:6-83) declares a
dataclass schema but reads many undeclared keys with plain attribute access /
``getattr(cfg, key, default)`` — the schema is *open*. We reproduce that
contract natively: a ``ConfigNode`` is an attribute-accessible mapping with a
set of declared defaults; any extra YAML keys are carried along untouched.

Three sections: ``model`` / ``train`` / ``wandb`` (reference:
owl_wms/configs.py:72-83), same key names so reference YAMLs map 1:1.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional


class ConfigNode:
    """Attribute-accessible open config mapping.

    Declared defaults give the closed-schema behavior of the reference
    dataclasses; arbitrary extra keys are accepted (open schema, see
    reference: owl_wms/configs.py docstring analysis in SURVEY.md §2.1).
    """

    def __init__(self, defaults: Optional[Dict[str, Any]] = None, **kwargs):
        object.__setattr__(self, "_data", {})
        if defaults:
            self._data.update(copy.deepcopy(defaults))
        for k, v in kwargs.items():
            self._data[k] = _wrap(v)

    # -- mapping / attribute protocol -------------------------------------
    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(f"Config has no key {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = _wrap(value)

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._data[name] = _wrap(value)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else v
        return out

    def merge(self, other: Dict[str, Any]) -> "ConfigNode":
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self._data.get(k), ConfigNode):
                self._data[k].merge(v)
            else:
                self._data[k] = _wrap(v)
        return self

    def copy(self) -> "ConfigNode":
        node = ConfigNode()
        node._data.update(
            {k: (v.copy() if isinstance(v, ConfigNode) else copy.deepcopy(v))
             for k, v in self._data.items()}
        )
        return node

    def __repr__(self):
        return f"ConfigNode({self._data!r})"


def _wrap(v: Any) -> Any:
    if isinstance(v, dict):
        return ConfigNode(**v)
    return v


# Declared defaults mirror the reference dataclasses
# (reference: owl_wms/configs.py:6-70), so omitted keys behave identically.
MODEL_DEFAULTS: Dict[str, Any] = dict(
    model_id=None,
    n_layers=12,
    n_heads=12,
    d_model=384,
    patch_size=1,
    channels=128,
    audio_channels=64,
    sample_size=16,
    cfg_prob=0.1,
    n_buttons=8,
    tokens_per_frame=16,
    audio_tokens=0,
    n_frames=120,
    causal=False,
    # Open-schema keys the reference reads via getattr with these defaults:
    backbone="dit",
    uncond=False,
    has_audio=False,
    rope_impl="ortho",
    local_window=None,
    global_window=None,
    local_idx=4,
    gradient_checkpointing=False,
    n_mouse_axes=2,
    # attention path selection (framework extensions)
    attn_impl="auto",     # uncached forwards: auto | dense | splash
    decode_impl="auto",   # cached decode: auto | dense
    cache_attn_impl="concat",  # ring+new merge: concat | noconcat
)

TRAIN_DEFAULTS: Dict[str, Any] = dict(
    trainer_id=None,
    data_id=None,
    target_batch_size=128,
    batch_size=2,
    epochs=200,
    opt="AdamW",
    opt_kwargs=None,
    loss_weights=None,
    scheduler=None,
    scheduler_kwargs=None,
    checkpoint_dir="checkpoints/v0",
    resume_ckpt=None,
    teacher_ckpt=None,
    teacher_cfg=None,
    sample_interval=1000,
    save_interval=1000,
    n_samples=8,
    sampler_id=None,
    sampler_kwargs=None,
    vae_id=None,
    vae_cfg_path=None,
    vae_ckpt_path=None,
    vae_scale=0.34,
    vae_batch_size=4,
)

WANDB_DEFAULTS: Dict[str, Any] = dict(
    name=None,
    project=None,
    run_name=None,
)


class Config:
    """Three-section config tree: model / train / wandb."""

    def __init__(self, model=None, train=None, wandb=None):
        self.model = ConfigNode(MODEL_DEFAULTS).merge(model or {})
        self.train = ConfigNode(TRAIN_DEFAULTS).merge(train or {})
        self.wandb = ConfigNode(WANDB_DEFAULTS).merge(wandb or {})

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls(
            model=raw.get("model"),
            train=raw.get("train"),
            wandb=raw.get("wandb"),
        )

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        return cls(
            model=raw.get("model"),
            train=raw.get("train"),
            wandb=raw.get("wandb"),
        )

    def to_dict(self):
        return {
            "model": self.model.to_dict(),
            "train": self.train.to_dict(),
            "wandb": self.wandb.to_dict(),
        }


# Alias matching the reference's per-section type name
# (reference: owl_wms/configs.py:6 TransformerConfig) for readability.
TransformerConfig = ConfigNode


def transformer_config(**kwargs) -> ConfigNode:
    """Construct a model config node with declared defaults."""
    return ConfigNode(MODEL_DEFAULTS).merge(kwargs)
