"""Token/image constants (parity: internvl/train/constants.py)."""

IMG_CONTEXT_TOKEN = "<IMG_CONTEXT>"
IMG_START_TOKEN = "<img>"
IMG_END_TOKEN = "</img>"
QUAD_START_TOKEN = "<quad>"
QUAD_END_TOKEN = "</quad>"
REF_START_TOKEN = "<ref>"
REF_END_TOKEN = "</ref>"
BOX_START_TOKEN = "<box>"
BOX_END_TOKEN = "</box>"

# The 9 special tokens added to the tokenizer by the train entry point
# (internvl_chat_finetune.py:1160-1172)
SPECIAL_TOKENS = (
    IMG_START_TOKEN, IMG_END_TOKEN, IMG_CONTEXT_TOKEN,
    QUAD_START_TOKEN, QUAD_END_TOKEN,
    REF_START_TOKEN, REF_END_TOKEN,
    BOX_START_TOKEN, BOX_END_TOKEN,
)

IGNORE_TOKEN_ID = -100

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.4814546, 0.4578275, 0.40821073)
CLIP_STD = (0.2686295, 0.2613025, 0.2757711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
