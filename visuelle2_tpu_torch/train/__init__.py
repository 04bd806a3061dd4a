"""Training, counterpart of ``visuelle2_tpu/train/``: so far only the
target/forecast alignment that scoring shares with it (``loop.py``)."""
