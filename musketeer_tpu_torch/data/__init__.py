from .file_dataset import FileDataset
from .task_data import (
    CaptionBuilder, Example, GigawordBuilder, GlueBuilder, ImageClassifyBuilder,
    RefcocoBuilder, SnliVeBuilder, VqaBuilder, collate, parse_ref_dict, pre_caption,
    pre_question,
)

__all__ = [
    "FileDataset", "CaptionBuilder", "Example", "GigawordBuilder", "GlueBuilder",
    "ImageClassifyBuilder", "RefcocoBuilder", "SnliVeBuilder", "VqaBuilder", "collate",
    "parse_ref_dict", "pre_caption", "pre_question",
]
