"""The plain reference the benchmark judges the program against.

Plain PyTorch and NumPy, float32 with TF32 off: the SSD anchors and
forward (``ssd.py``; each architecture's layers in
``perfbench/architectures/``), the Caffe-style decode with greedy NMS
(``decode.py``), the Pascal-VOC matching and 11-point AP (``voc.py``) and
the numbers that compare the program's detections with the reference's
(``compare.py``). Nothing here imports ``ssd_keras_torch``, ``ssd_keras_tpu`` or JAX, and
nothing here takes a tensor the program made, other than the program's
outputs that it judges.
"""
