"""Device milliseconds of the LSTM recurrence steps per traced request:
cuDNN's RNN kernels (elemWiseRNNcell) and the matrix product launched
right before each (the step's h @ W_hh, a gemv at batch 1) of the text
encoder's, the duration encoder's and head's LSTMs over tokens and the
prosody predictor's shared BiLSTM over frames."""

import re

CELL = re.compile(r"(?i)rnn|lstm")
STEP_PRODUCT = re.compile(r"(?i)gemm|gemv")


def read(ctx):
    if ctx.trace is None or not ctx.trace_records:
        return None
    total, prev = 0.0, None
    for op in ctx.trace.ops:
        if CELL.search(op[0]):
            total += op[2]
            if prev is not None and STEP_PRODUCT.search(prev[0]):
                total += prev[2]
            prev = None
        else:
            prev = op
    return 1e3 * total / len(ctx.trace_records) if total > 0 else None
