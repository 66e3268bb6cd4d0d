"""The user workflows of the port, one module each, run as
``python -m ssd_keras_torch.examples.<name>``.

Ports of the JAX package's ``examples/`` scripts, with their command-line
flags and the lines their drivers parse:

* ``ssd300_training``, ``ssd7_training`` -- train (the host augmentation
  chains, or the on-device pipeline with ``--device_pipeline``; one process
  a card with ``--data_parallel``);
* ``ssd300_inference``, ``ssd512_inference`` -- detections printed in the
  original images' coordinates;
* ``ssd300_evaluation`` (Pascal-VOC mAP, results files),
  ``ssd300_evaluation_coco`` (COCO results JSON and its stats);
* ``export_h5`` (a port checkpoint to a Keras-layout ``.h5``),
  ``weight_sampling`` (a ``.h5``'s class heads to another class count);
* ``synthetic_smoke_ssd300`` (an overfit smoke), ``synthvoc_benchmark``
  (train to a validation-mAP curve on SynthVOC) and
  ``run_workflows_synthvoc`` (every workflow above on a SynthVOC export);
* the accuracy A/Bs: ``aug_chain_ab`` (the host augmentation chain against
  the device chain, by mAP), ``bf16_vs_f32_ssd300`` (bf16 against f32
  training from one init) and ``evaluator_decode_agreement`` (the device
  decode against the host decoder on crowded scenes).

Each runs on the card (``--device cuda``, the default) unless given
``--device cpu``; without a card, the default raises. Weights come from a
Keras ``.h5`` (``--weights``, needs h5py) or from the port's own checkpoint
(``--checkpoint``, a ``Trainer.save_checkpoint`` file). Importing a module
here runs nothing.
"""
