from wav2vec_s_tpu_torch.models.caat.config import CaatConfig, caat_base_config
from wav2vec_s_tpu_torch.models.caat.decoder import IsolatedDecoder
from wav2vec_s_tpu_torch.models.caat.jointer import MHAJointNet
from wav2vec_s_tpu_torch.models.caat.transducer_model import W2V2CaatModel
