from repro_torch.optim.optimizers import (Optimizer, adamw,
                                          clip_by_global_norm, sgd_momentum)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup_cosine)
from repro_torch.optim.compression import (int8_dequantize, int8_quantize,
                                           topk_compress_with_feedback)

__all__ = ["Optimizer", "adamw", "sgd_momentum", "clip_by_global_norm",
           "constant", "cosine_decay", "linear_warmup_cosine",
           "topk_compress_with_feedback", "int8_quantize",
           "int8_dequantize"]
