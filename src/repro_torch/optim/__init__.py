from .adam8bit import Adam8bit
from .adamw import AdamW
from .muon import Muon
from .sgd import SGDMomentum
from .shampoo import Shampoo

OPTIMIZERS = {
    "adamw": AdamW,
    "sgd": SGDMomentum,
    "adam8bit": Adam8bit,
    "muon": Muon,
    "shampoo": Shampoo,
}


def make_optimizer(cfg):
    return OPTIMIZERS[cfg.optimizer](cfg)
