from visuelle2_tpu_torch.models.base import VocabSizes, flatten_windows, repeat_windows
from visuelle2_tpu_torch.models.gtm_v1 import GTM_V1_NORM_SCALAR, GTMv1, TextFeaturizer
from visuelle2_tpu_torch.models.oracle import Oracle
from visuelle2_tpu_torch.models.registry import build, model_names
from visuelle2_tpu_torch.models.seq2seq import VARIANTS, Seq2SeqForecaster

__all__ = ["VocabSizes", "flatten_windows", "repeat_windows", "build", "model_names",
           "Seq2SeqForecaster", "VARIANTS", "GTMv1", "GTM_V1_NORM_SCALAR", "TextFeaturizer",
           "Oracle"]
