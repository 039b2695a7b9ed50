"""Ensemble-speculative decoding: the distilled student drafts, its
teachers verify.

The compression loop (core/compression.py) distills one student that
imitates the K-member ensemble.  Serving keeps both: the student
proposes gamma tokens a request an iteration (draft.py), the full Eqn-6
fused ensemble scores every drafted position in one batched pass
(models/transformer.verify_slots / verify_step_paged) and accepts the
longest prefix the fused choice agrees with (verify.py).  Greedy
acceptance emits the plain fused engine's tokens; the ensemble pays its
K-fold cost once an accepted run instead of once a token.
engine.SpeculativeEngine serves the loop behind the EnsembleEngine API.
"""
from repro_torch.serving.spec.draft import (DraftEngine, as_member_stack,
                                            propose)
from repro_torch.serving.spec.engine import SpeculativeEngine
from repro_torch.serving.spec.verify import (greedy_accept,
                                             residual_log_probs,
                                             stochastic_accept)

__all__ = ["SpeculativeEngine", "DraftEngine", "as_member_stack",
           "propose", "greedy_accept", "stochastic_accept",
           "residual_log_probs"]
