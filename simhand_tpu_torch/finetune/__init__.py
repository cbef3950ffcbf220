"""Fine-tuning and evaluation of the detnet hand-pose head (counterpart of
``simhand_tpu/finetune``): the datasets and the sample builder with its
image stage on the device, the maps, the detnet, its loss, the metrics,
the trainer and the evaluation CLI."""
