"""paper_nin — the paper's own CIFAR-100 NiN setup (Section 5.1).

Not an LM: family="cnn" routes through models/cnn.py.  This is the faithful
EC-DNN reproduction config: K in {4, 8}, tau in {20, 30, 40} epochs,
lambda=0.5 annealed over p=tau/2, relabel fraction 0.7, momentum SGD + l2.
"""
from repro_torch.common.types import ECConfig, ModelConfig

CONFIG = ModelConfig(
    name="paper_nin", family="cnn",
    n_layers=9, d_model=192, vocab_size=100,  # vocab_size = n_classes
    max_seq=1024,  # 32*32 pixels; unused by the CNN path
)

PAPER_EC = ECConfig(tau=40, lam=0.5, p_steps=20, relabel_fraction=0.7,
                    label_mode="dense", aggregator="ec")


def reduced() -> ModelConfig:
    return CONFIG
