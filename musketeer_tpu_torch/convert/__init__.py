from .fairseq import convert_state_dict, export_state_dict, infer_config, load_checkpoint

__all__ = ["convert_state_dict", "export_state_dict", "infer_config", "load_checkpoint"]
