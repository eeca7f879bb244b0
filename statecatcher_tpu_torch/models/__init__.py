"""Models: SpeechModel → ASRModel → LSTMEncoder, LucyRNNEncoder → LucyCell,
XLSTMEncoder → MLSTMLayer, or RWKVEncoder.

Every model follows the JAX package's stateful contract,
``logits, new_state = model(feats, state, frame_mask)``, with the state a
dict of batch-major tensors: LucyRNN's {"h", "s"} (B, tracks, L, D), the
xLSTM's {"C", "n", "m"}, RWKV's five (B, L, D) leaves.
"""

from statecatcher_tpu_torch.models.asr import ASRModel, build_model, init_carry
from statecatcher_tpu_torch.models.lucyrnn import LucyRNNEncoder
from statecatcher_tpu_torch.models.rwkv import RWKVEncoder
from statecatcher_tpu_torch.models.speech import SpeechModel, build_speech_model
from statecatcher_tpu_torch.models.xlstm import XLSTMEncoder

__all__ = ["ASRModel", "LucyRNNEncoder", "RWKVEncoder", "SpeechModel", "XLSTMEncoder",
           "build_model", "build_speech_model", "init_carry"]
