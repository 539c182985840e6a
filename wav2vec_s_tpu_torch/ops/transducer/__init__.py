from wav2vec_s_tpu_torch.ops.transducer.analytic import (
    DelayTransducerLoss, delay_transducer_loss)
from wav2vec_s_tpu_torch.ops.transducer.lattice import (
    DELAY_FUNCS, delay_cost_diag_positive, delay_cost_diagonal,
    delay_cost_zero)
