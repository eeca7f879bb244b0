"""Models: SpeechModel → ASRModel → LucyRNNEncoder → LucyCell.

Every model follows the JAX package's stateful contract,
``logits, new_state = model(feats, state, frame_mask)``, with the state a
dict of batch-major (B, tracks, L, D) tensors.
"""

from statecatcher_tpu_torch.models.asr import ASRModel, build_model, init_carry
from statecatcher_tpu_torch.models.lucyrnn import LucyRNNEncoder
from statecatcher_tpu_torch.models.speech import SpeechModel, build_speech_model

__all__ = ["ASRModel", "LucyRNNEncoder", "SpeechModel", "build_model",
           "build_speech_model", "init_carry"]
