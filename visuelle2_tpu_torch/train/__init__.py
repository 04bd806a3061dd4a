"""Training, counterpart of ``visuelle2_tpu/train/``: the optimizer
(``optim.py``), the trainer (``loop.py``), checkpoints (``checkpoint.py``)
and the hyperparameter manifest (``hparams.py``)."""
