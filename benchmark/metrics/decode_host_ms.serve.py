"""Host ms a forward spends in the CrossAttnRNN decode loop
(``models/cross_attn_rnn.py::_decode``, ``out_len`` steps): the program's
``decode.step`` spans summed by the forward that holds them, the median
over forwards (``benchmark/spans.py``); beside ``decode_device_ms.serve``
it says whether the host or the device sets the loop's pace."""

from benchmark import spans


def read(ctx):
    return spans.median_per_parent_ms("decode.step")
