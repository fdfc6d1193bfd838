from repro_torch.checkpoint.msgpack_ckpt import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
