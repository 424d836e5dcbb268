from .adamw import AdamW

OPTIMIZERS = {"adamw": AdamW}


def make_optimizer(cfg):
    if cfg.optimizer not in OPTIMIZERS:
        item = "Queue 1 item 8" if cfg.optimizer == "adam8bit" \
            else "Queue 1 item 15"
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (ROADMAP {item})")
    return OPTIMIZERS[cfg.optimizer](cfg)
