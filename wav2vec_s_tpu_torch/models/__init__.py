from wav2vec_s_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config, Wav2Vec2Model, wav2vec2_base_config, wav2vec_s_base_config)
