from .adam8bit import Adam8bit
from .adamw import AdamW

OPTIMIZERS = {"adamw": AdamW, "adam8bit": Adam8bit}


def make_optimizer(cfg):
    if cfg.optimizer not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (ROADMAP "
            f"Queue 1 item 15)")
    return OPTIMIZERS[cfg.optimizer](cfg)
