from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          sgd_momentum)

__all__ = ["Optimizer", "sgd_momentum", "clip_by_global_norm"]
