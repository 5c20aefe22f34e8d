from .detection import DetectionBuilder
from .file_dataset import FileDataset
from .pretrain import (
    ImageTextMatchingBuilder, ImageTextPairBuilder, PureImageBuilder, TextInfillingBuilder,
    VisualGroundingBuilder,
)
from .task_data import (
    CaptionBuilder, Example, GigawordBuilder, GlueBuilder, ImageClassifyBuilder,
    ImageGenBuilder, RefcocoBuilder, SnliVeBuilder, VqaBuilder, collate, parse_ref_dict, pre_caption,
    pre_question,
)

__all__ = [
    "DetectionBuilder", "ImageTextMatchingBuilder", "ImageTextPairBuilder", "PureImageBuilder",
    "TextInfillingBuilder", "VisualGroundingBuilder", "FileDataset", "CaptionBuilder", "Example", "GigawordBuilder", "GlueBuilder",
    "ImageClassifyBuilder", "ImageGenBuilder", "RefcocoBuilder", "SnliVeBuilder", "VqaBuilder", "collate",
    "parse_ref_dict", "pre_caption", "pre_question",
]
