"""Training entry point of the port:

    python -m owl_audio_exps_tpu_torch.train --config_path configs/dit_v4_tpu_e2e.yml --max_steps N

Runs on the card (``cuda``) unless ``--device cpu`` (or ``train.device``
in the config) asks for the CPU. One process, one device.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from .configs import Config
    from .trainers import get_trainer_cls

    cfg = Config.from_yaml(args.config_path)
    trainer = get_trainer_cls(cfg.train.trainer_id)(cfg, device=args.device)
    trainer.train(max_steps=args.max_steps)


if __name__ == "__main__":
    main()
