"""The input path (counterpart of ``simhand_tpu/data``): the packed crop
cache, the raw pair batches, their page-locked staging and prefetch onto the
card and the augmentation on the card. Nothing here imports ``cv2`` when it is
imported: the card's machine has none."""
