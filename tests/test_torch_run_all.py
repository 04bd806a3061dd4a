"""``cli/run_all.py`` against the JAX ``run_all``: with every CLI's ``run``
replaced by a recorder, both pipelines hand the same CLIs the same
arguments in the same order (the port's ``--device`` aside), and each
forecast gets the checkpoint its training returned.  The real chained run
is ``chip_smoke.py``'s run_all phase, on the card."""

import pytest

from visuelle2_tpu.cli import forecast_dl as jforecast_dl
from visuelle2_tpu.cli import forecast_stat as jforecast_stat
from visuelle2_tpu.cli import run_all as jrun_all
from visuelle2_tpu.cli import train_dl as jtrain_dl
from visuelle2_tpu_torch.cli import forecast_dl, forecast_stat, run_all, train_dl

FLAGS = ["--dataset_path", "d", "--batch_size", "16", "--epochs", "2", "--image_arch",
         "tiny", "--image_size", "32", "--ckpt_root", "cks"]


def _record(monkeypatch, modules):
    """Replace each CLI module's ``run`` by one that records ``(cli, flags)``
    and returns what the pipeline hands on: a checkpoint path from training,
    a result otherwise."""
    calls = []

    def recorder(cli):
        def run(args, *rest, **kw):
            calls.append((cli, vars(args)))
            if cli == "train_dl":
                return f"{args.ckpt_dir}/best"
            return (1.0, 2.0) if cli == "forecast_stat" else f"scored {args.ckpt_path}"
        return run

    for cli, module in modules.items():
        monkeypatch.setattr(module, "run", recorder(cli))
    return calls


@pytest.mark.parametrize("extra", [[], ["--quick_debug", "--accum_steps", "2", "--remat"]])
def test_run_all_hands_each_cli_the_jax_arguments(monkeypatch, extra):
    jcalls = _record(monkeypatch, {"train_dl": jtrain_dl, "forecast_dl": jforecast_dl,
                                   "forecast_stat": jforecast_stat})
    monkeypatch.setattr("sys.argv", ["run_all", *FLAGS, *extra])
    jrun_all.main()
    calls = _record(monkeypatch, {"train_dl": train_dl, "forecast_dl": forecast_dl,
                                  "forecast_stat": forecast_stat})
    results = run_all.main([*FLAGS, *extra, "--device", "cpu"])
    assert [c for c, _ in calls] == [c for c, _ in jcalls] == [
        "train_dl", "forecast_dl"] * 3 + ["forecast_stat"] * 3
    for (cli, ours), (_, theirs) in zip(calls, jcalls):
        assert ours.pop("device") == "cpu"
        assert ours == theirs, cli
    # Each forecast scores the checkpoint its training returned.
    trained = [args["ckpt_dir"] for c, args in calls if c == "train_dl"]
    scored = [args["ckpt_path"] for c, args in calls if c == "forecast_dl"]
    assert scored == [f"{d}/best" for d in trained]
    assert trained == ["cks/ckpt_21", "cks/ckpt_210", "cks/ckpt_demand"]
    assert list(results) == ["so_fore_2_1", "so_fore_2_10", "demand", "stat_naive",
                             "stat_ses", "stat_holt"]
