from visuelle2_tpu_torch.models.base import VocabSizes, flatten_windows, repeat_windows
from visuelle2_tpu_torch.models.registry import build
from visuelle2_tpu_torch.models.seq2seq import VARIANTS, Seq2SeqForecaster

__all__ = ["VocabSizes", "flatten_windows", "repeat_windows", "build",
           "Seq2SeqForecaster", "VARIANTS"]
