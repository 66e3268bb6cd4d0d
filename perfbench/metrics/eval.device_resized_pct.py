"""The share of the traced pass's images (``eval.images``) that the
evaluator decoded, coloured and resized on the card without a host copy
(the program's counter ``data.device_resized``, which the evaluator's card
source counts every batch, 0 for a batch left to the host): how often the
card's resize path engages. None where the program has no such counter."""


def read(run):
    from perfbench import program

    counted = program.counts(run)
    images = counted.get("eval.images")
    if not images or "data.device_resized" not in counted:
        return None
    return 100.0 * counted["data.device_resized"] / images
