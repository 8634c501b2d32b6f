from vers_tpu_torch.io.bincode import Reader, Writer

__all__ = ["Reader", "Writer"]
