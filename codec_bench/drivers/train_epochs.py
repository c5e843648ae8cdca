"""Training through graphed epochs (``codec_bench/training.py``): one
model's ``train_step``, or with ``"ladder": true`` in the traffic every
model of the configuration's ``gammas`` as one stacked program."""

from codec_bench import training


def run(context):
    return training.run(context, ladder=context.traffic.get("ladder", False))
