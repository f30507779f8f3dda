from goma_tpu_torch.utils.la import det_and_inv
