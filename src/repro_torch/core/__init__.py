"""Plain PyTorch forms of the paper's primitives (port of ``repro.core``)."""
from repro_torch.core.attention import (naive_attention,  # noqa: F401
                                        online_attention,
                                        online_attention_lse)
from repro_torch.core.cross_entropy import (  # noqa: F401
    chunked_cross_entropy, full_cross_entropy)
from repro_torch.core.online_softmax import (  # noqa: F401
    ACCESSES_PER_ELEMENT, combine, identity_like, naive_softmax,
    online_log_softmax, online_logsumexp, online_normalizer,
    online_normalizer_blocked, online_normalizer_scan, online_softmax,
    safe_softmax)
from repro_torch.core.topk_fusion import (  # noqa: F401
    SoftmaxTopK, gumbel_noise, gumbel_pick, safe_softmax_then_topk,
    softmax_topk)
