"""visuelle2_tpu_torch — the PyTorch / CUDA (NVIDIA H100) port of visuelle2_tpu.

The JAX package ``visuelle2_tpu`` stays the reference; this package mirrors
its layout (``ops/``, ``models/``, ``data/``, ``eval/``) and its module and
parameter names, so each counterpart is found by name and the weight bridge
(``convert.py``) stays mechanical.  It imports torch and numpy only — never
jax, flax or anything of ``visuelle2_tpu``.

Every TPU kernel on a ported path is a kernel written by hand for Hopper
(``csrc/``, built at first use by ``ops/cuda/_build.py``).  On a CUDA tensor
a kernel wrapper launches its kernel or raises; the plain PyTorch version
beside it runs only for CPU tensors.

Ported so far: the eval forwards of the seq2seq family (``gtm``, ``m4ft``,
``gated_v1`` … ``gated_v4``) and of the CrossAttnRNN family
(``cross_attn_rnn_21``, ``cross_attn_rnn_210``, ``cross_attn_rnn_demand``),
the HTTP server that serves them (``models.build``,
``eval.export.make_forecaster``, ``eval.server.make_server``), and scoring a
dataset's test split (``data``, ``eval.forecast.score_split`` and the CLIs
``cli.forecast_transformer`` and ``cli.forecast_dl``), and training the
seq2seq family (train mode of its modules, ``train.optim.Adafactor``,
``train.loop.Trainer``, ``train.checkpoint``, ``train.hparams`` and
``cli.train_transformer``; ``forecast_transformer --ckpt_path`` scores a
trained checkpoint), training the CrossAttnRNN family (``cli.train_dl``),
the VISUELLE-1 GTM (``gtm_v1``), the statistical baselines (``oracle``,
``ops.stats``, ``cli.forecast_stat``), the whole task list
(``cli.run_all``) and the legacy InceptionV3 blocks (``models.inception``,
``models.legacy``): all 11 registry models; and serving from an artifact
(``eval.export.export_forecaster`` / ``load_forecaster`` with int8 weight
storage, ``cli.export``, ``cli.serve``, ``eval.server.serve_forever``,
``eval.client``) and the pretrained-backbone splice (``models.pretrained``,
``--pretrained_backbone``).  Entry points put the model on ``cuda`` unless
the caller passes ``device="cpu"`` (``_device.resolve_device``,
``--device`` on the CLIs).

Numeric traps the tests guard (each is restated where it lives):

* flax ``LayerNorm`` eps is 1e-6, not torch's 1e-5 — every LayerNorm sets it;
* the gate kernel of ``TextGuidedFusionNetwork`` is laid over ``[ctx, x]``;
* BatchNorm is folded in the working dtype as ``models/resnet.py`` does;
* ``normalize_images`` computes in the working dtype, so bf16 rounds alike;
* the bf16 pooled image mean is cast to f32 before the fusion;
* CrossAttnRNN patch tokens are flattened from NHWC, as in JAX, though the
  backbone returns an NCHW view of channels_last memory;
* attention masks are additive 0 / −inf; the trend encoder has 4 heads;
* cuDNN runs f32 convolutions in TF32 by default: comparisons in f32 set
  ``torch.backends.cudnn.allow_tf32 = False``;
* the bf16 backbone keeps float32 master weights, cast on each call, as the
  JAX ``param_dtype``: an optimizer update would vanish in a bf16 weight;
* a kernel wrapper called on inputs that need a gradient runs under a
  ``torch.autograd.Function`` whose backward is torch ops (the Pallas
  originals have no VJP either).
"""
