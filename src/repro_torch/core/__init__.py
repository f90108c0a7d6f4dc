"""Plain PyTorch forms of the paper's primitives (port of ``repro.core``)."""
from repro_torch.core.attention import (naive_attention,  # noqa: F401
                                        online_attention,
                                        online_attention_lse)
from repro_torch.core.cross_entropy import (  # noqa: F401
    chunked_cross_entropy, full_cross_entropy)
from repro_torch.core.online_softmax import (combine,  # noqa: F401
                                             online_normalizer, safe_softmax)
from repro_torch.core.topk_fusion import (SoftmaxTopK, gumbel_noise,  # noqa: F401
                                          gumbel_pick, softmax_topk)
