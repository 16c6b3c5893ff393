from adipose_tpu_torch.serving.export import export_model, load_exported

__all__ = ["export_model", "load_exported"]
