"""Task prompt templates (base / TEP / onehot variants).
(A copy of ``musketeer_tpu/data/prompts.py``.)

These strings are PROMPT DATA, not code: Musketeer disambiguates tasks purely
through these Task Explanation Prompts, so they must match the reference
byte-for-byte for checkpoint-compatible behavior. Sources cited per task.
Format-holes use ``str.format``.
"""

# ---------------------------------------------------------------------------
# caption (ref: data/mm_data/caption_dataset.py:76-127)
# ---------------------------------------------------------------------------
CAPTION_BASE = " what does the image describe?"
CAPTION_TEP = (
    "Dataset Description: Dataset Description: RIn addition to object detection, the COCO dataset also includes annotations for image captioning. Image captioning involves generating a natural language description of the objects and scenes depicted in an image."
    "To annotate a dataset for image captioning, annotators must assign a series of text descriptions to each image in the dataset. These descriptions should capture the key objects and scene elements present in the image, as well as their relationships and interactions."
    "Input format: A Task Prompt  and an Image "
    "Output format: Text describe this image "
    "Output description: Text that describe the input image"
    "Prompt: what does the image describe?"
)
CAPTION_ONEHOT = "0001000"

# ---------------------------------------------------------------------------
# refcoco / visual grounding (ref: data/mm_data/refcoco_dataset.py:79-134)
# ---------------------------------------------------------------------------
REFCOCO_BASE = 'which region does the text " {} " describe?'
REFCOCO_TEP = (
    'Dataset Description: RefCOCO is a dataset for referring expressions in images, which is built on top of the COCO dataset. Referring expressions are natural language phrases that refer to specific objects or regions in an image. For example, a referring expression might be "the dog in the center of the picture" or "the red car on the right side of the image".'
    "Annotating a dataset like RefCOCO involves manually labeling the objects in each image with bounding boxes and class labels, as well as creating referring expressions that refer to specific objects or regions in the image. This is typically done by trained annotators who use specialized software tools to draw the bounding boxes and assign the class labels, as well as to generate the referring expressions."
    "Input format: A Task Prompt, a Text describing the target region and a Image containing the target region"
    "Output format: x0 + y0 + x1 + y1"
    "Output description: horizonal coordinates of leftupper points of target region +  vertical coordinates of leftupper points of target region  + horizonal coordinates of rightlower points of target region +  vertical coordinates of rightlower points of target region "
    'Prompt: which region does the text " {} " describe?'
)

# ---------------------------------------------------------------------------
# vqa (ref: data/mm_data/vqa_gen_dataset.py:126-141)
# ---------------------------------------------------------------------------
VQA_BASE = " {}"
VQA_TEP = (
    "Dataset Description: VQAv2 is a dataset for visual question answering (VQA), which is a task that involves generating natural language answers to questions about images. The VQAv2 dataset is a large-scale dataset that includes over 200,000 images and more than 1.2 million questions and answers."
    "Annotating a dataset like VQAv2 involves manually labeling the images with questions and answers. This is typically done by trained annotators who use specialized software tools to create the questions and answers. The questions should be natural language questions that are related to the content of the images, and the answers should be natural language responses that provide accurate and relevant information about the images."
    "Input format: A Task Prompt ,  a question description text  and  a description image"
    "Output format: Text"
    "Output description:  Answers "
    "Prompt: {}"
)
VQA_ONEHOT = " 0100000 {}"

# ---------------------------------------------------------------------------
# snli-ve / visual entailment (ref: data/mm_data/snli_ve_dataset.py:199-215)
# ---------------------------------------------------------------------------
SNLI_BASE = ' can image and text1 " {} " imply text2 " {} "?'
SNLI_TEP = (
    "Dataset Description: SNLI-VE is a dataset for visual entailment, which is the task of determining whether a given natural language sentence is entailed by a given image. The SNLI-VE dataset is a large-scale dataset that includes over 200,000 images and more than 1.2 million sentence pairs."
    "Annotating a dataset like SNLI-VE involves manually labeling the images with sentence pairs and labels indicating whether the sentences are entailed by the image. This is typically done by trained annotators who use specialized software tools to create the sentence pairs and assign the labels. The sentences should be natural language sentences that are related to the content of the images, and the labels should indicate whether one sentence logically follows from the other given the information in the image."
    "Input format: A Task Prompt,  a condition Text 1 , a implied result Text 2 and an  Image"
    "Output format: yes or no or maybe"
    "Output description:  can imply or can not imply or maybe imply"
    ' Prompt: can image and text1 " {} " imply text2 " {} "?'
)

# ---------------------------------------------------------------------------
# image classification (ref: data/cv_data/image_classify_dataset.py:108-121)
# ---------------------------------------------------------------------------
IMAGE_CLASSIFY_BASE = " what does the image describe?"
IMAGE_CLASSIFY_TEP = (
    "Dataset Description:  ImageNet is a large-scale dataset for image classification, object detection, and object segmentation. It contains over 14 million images, each labeled with the name of one of 1000 object categories. The images in ImageNet are annotated by human labelers, who have assigned a label to each image indicating the main object or concept depicted in it."
    "The annotation process for ImageNet involves two steps: (1) determining the set of object categories to be used for labeling the images and (2) labeling the images with these categories."
    'Determining the set of object categories: The object categories used for ImageNet were determined through a process called "WordNet hierarchy expansion." WordNet is a large database of English words and their relationships to one another. The ImageNet organizers used WordNet to expand the set of object categories to include all the nouns in WordNet, resulting in a list of over 200,000 categories. They then selected a subset of these categories to use for ImageNet, based on their relevance to image classification and their difficulty level. The final set of categories used in ImageNet consists of 1000 object categories.'
    "Labeling the images: Once the set of object categories has been determined, the images in ImageNet are labeled by human annotators. The annotators are shown an image and asked to select the object category that best describes the main object or concept depicted in the image. In some cases, multiple object categories may be applicable to a single image. In these cases, the annotators are asked to select all the relevant categories."
    "Input format: Task prompt and an input Image"
    "Output format: Text "
    "Output description: A class name this image describe"
    "Prompt:  what does the image describe?"
)

# ---------------------------------------------------------------------------
# detection (ref: data/cv_data/detection_dataset.py:378-396)
# ---------------------------------------------------------------------------
DETECTION_BASE = "what are the objects in the image? "
DETECTION_TEP = (
    "Dataset Description: COCO, or the Common Objects in Context dataset, is a large-scale dataset for object detection, segmentation, and captioning. The dataset is commonly used to train and evaluate object detection algorithms."
    "Annotating a dataset like COCO involves manually labeling the objects in each image with bounding boxes and class labels. This is typically done by trained annotators who use specialized software tools to draw the bounding boxes and assign the class labels to the objects in the images."
    "Input format: A Task Prompt  and a Image containing target objects"
    "Output format: mutiple {x0 + y0 + x1 + y1} "
    "Output description: mutiple bounding boxes (each consists of horizonal coordinates of leftupper points of target region +  vertical coordinates of leftupper points of target region  + horizonal coordinates of rightlower points of target region +  vertical coordinates of rightlower points of target region )"
    "Prompt: what are the objects in the image?"
)

# ---------------------------------------------------------------------------
# gigaword summarization (ref: data/nlg_data/summary_dataset.py:90-98)
# ---------------------------------------------------------------------------
GIGAWORD_BASE = ' what is the summary of article " {} "?'
GIGAWORD_TEP = (
    "Dataset description: Gigaword is a large-scale dataset for natural language processing tasks, such as language modeling and machine translation. It contains over 5 billion words of text, drawn from a variety of sources, including news articles, books, and websites.The annotation process for Gigaword involves collecting text from a variety of sources and ensuring that it is accurately"
    " transcribed and formatted. The text is then divided into smaller units, such as sentences or paragraphs, and annotated with additional information, such as part-of-speech tags or named entity tags. "
    "Input format: Text"
    "Output format: Text"
    "Output description: summary of input text"
    'prompt: what is the summary of article " {} "? '
)

# ---------------------------------------------------------------------------
# text-to-image generation (ref: data/mm_data/image_gen_dataset.py:146-166)
# ---------------------------------------------------------------------------
IMAGE_GEN_BASE = " what is the complete image? caption: {}"
IMAGE_GEN_TEP = (
    "Dataset Description: In addition to object detection, the COCO dataset also includes annotations for image captioning. Image captioning involves generating a natural language description of the objects and scenes depicted in an image."
    "To annotate a dataset for image captioning, annotators must assign a series of text descriptions to each image in the dataset. These descriptions should capture the key objects and scene elements present in the image, as well as their relationships and interactions."
    "Input format: A Task Prompt , a Text describing target image"
    "Output format: Image"
    "Output description:  Generated image this caption describe"
    "Prompt: what is the complete image? caption: {}"
)


PROMPTS = {
    "caption": {"base": CAPTION_BASE, "tep": CAPTION_TEP, "onehot": CAPTION_ONEHOT},
    "refcoco": {"base": REFCOCO_BASE, "tep": REFCOCO_TEP},
    "vqa_gen": {"base": VQA_BASE, "tep": VQA_TEP, "onehot": VQA_ONEHOT},
    "snli_ve": {"base": SNLI_BASE, "tep": SNLI_TEP},
    "image_classify": {"base": IMAGE_CLASSIFY_BASE, "tep": IMAGE_CLASSIFY_TEP},
    "detection": {"base": DETECTION_BASE, "tep": DETECTION_TEP},
    "gigaword": {"base": GIGAWORD_BASE, "tep": GIGAWORD_TEP},
    "image_gen": {"base": IMAGE_GEN_BASE, "tep": IMAGE_GEN_TEP},
}


def get_prompt(task: str, description: str = "tep") -> str:
    return PROMPTS[task][description]
