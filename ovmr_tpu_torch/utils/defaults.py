"""Default configuration tree.

The port's copy of ``ovmr_tpu/utils/defaults.py``. Key names match the
reference so its yaml files merge unchanged
(``Dassl.pytorch/dassl/config/defaults.py:1-313`` + the OVMR extensions from
``train.py:100-132``), including the DA/DG/SSL trainer hyper-param families.
Where the JAX package has its ``TPU`` node (``:239-296``) the port has a
``CUDA`` node holding the keys that mean something on a CUDA card; the
config reader maps a ``TPU`` key onto its ``CUDA`` twin
(:mod:`ovmr_tpu_torch.utils.config`).
"""

from __future__ import annotations

from .config import CfgNode


def get_cfg_default() -> CfgNode:
    c = CfgNode()

    c.VERSION = 1
    c.OUTPUT_DIR = "./output"
    c.RESUME = ""
    c.SEED = -1
    c.USE_CUDA = True  # accepted for config compatibility; the device is CUDA.DEVICE
    c.VERBOSE = True
    c.TEXT_ONLY = False
    c.GPU_NUMS = -1
    c.TASK_ID = 0

    # ---- input -----------------------------------------------------------
    c.INPUT = CfgNode()
    c.INPUT.SIZE = (224, 224)
    c.INPUT.INTERPOLATION = "bilinear"
    c.INPUT.TRANSFORMS = ()
    c.INPUT.NO_TRANSFORM = False
    c.INPUT.PIXEL_MEAN = [0.485, 0.456, 0.406]
    c.INPUT.PIXEL_STD = [0.229, 0.224, 0.225]
    c.INPUT.CROP_PADDING = 4
    c.INPUT.RRCROP_SCALE = (0.08, 1.0)
    c.INPUT.CUTOUT_N = 1
    c.INPUT.CUTOUT_LEN = 16
    c.INPUT.GN_MEAN = 0.0
    c.INPUT.GN_STD = 0.15
    c.INPUT.RANDAUGMENT_N = 2
    c.INPUT.RANDAUGMENT_M = 10
    c.INPUT.COLORJITTER_B = 0.4
    c.INPUT.COLORJITTER_C = 0.4
    c.INPUT.COLORJITTER_S = 0.4
    c.INPUT.COLORJITTER_H = 0.1
    c.INPUT.RGS_P = 0.2
    c.INPUT.GB_P = 0.5
    c.INPUT.GB_K = 21

    # ---- dataset -----------------------------------------------------------
    c.DATASET = CfgNode()
    c.DATASET.ROOT = ""
    c.DATASET.REGION_AUG = False
    c.DATASET.REGION_SCALE = [224]
    c.DATASET.TEST_REGION_SCALE = [224]
    c.DATASET.NAME = ""
    c.DATASET.SOURCE_DOMAINS = ()
    c.DATASET.TARGET_DOMAINS = ()
    c.DATASET.NUM_LABELED = -1
    c.DATASET.NUM_SHOTS = -1
    c.DATASET.VAL_PERCENT = 0.1
    c.DATASET.STL10_FOLD = -1
    c.DATASET.CIFAR_C_TYPE = ""
    c.DATASET.CIFAR_C_LEVEL = 1
    c.DATASET.ALL_AS_UNLABELED = False
    c.DATASET.SUBSAMPLE_CLASSES = "all"  # all, base or new

    # ---- dataloader --------------------------------------------------------
    c.DATALOADER = CfgNode()
    c.DATALOADER.NUM_WORKERS = 4
    c.DATALOADER.K_TRANSFORMS = 1
    c.DATALOADER.RETURN_IMG0 = False
    # batch-level multi-resolution collate (reference data_manager.py:15-67
    # collate_fn_custom — defined there, never wired; opt-in here). Random
    # per-batch aspect ratio + short side, dims floored to patch multiples;
    # the ratio comes from a bounded grid (the JAX package's data/multires.py,
    # not ported yet). Replaces the per-image train transform pipeline.
    c.DATALOADER.MULTI_RES_COLLATE = False
    c.DATALOADER.COLLATE_FN = "none"
    c.DATALOADER.TRAIN_X = CfgNode()
    c.DATALOADER.TRAIN_X.SAMPLER = "RandomSampler"
    c.DATALOADER.TRAIN_X.BATCH_SIZE = 32
    c.DATALOADER.TRAIN_X.N_DOMAIN = 0
    c.DATALOADER.TRAIN_X.N_INS = 16
    c.DATALOADER.TRAIN_U = CfgNode()
    c.DATALOADER.TRAIN_U.SAME_AS_X = True
    c.DATALOADER.TRAIN_U.SAMPLER = "RandomSampler"
    c.DATALOADER.TRAIN_U.BATCH_SIZE = 32
    c.DATALOADER.TRAIN_U.N_DOMAIN = 0
    c.DATALOADER.TRAIN_U.N_INS = 16
    c.DATALOADER.TEST = CfgNode()
    c.DATALOADER.TEST.SAMPLER = "SequentialSampler"
    c.DATALOADER.TEST.BATCH_SIZE = 32
    c.DATALOADER.TEST.N_INS = 16

    # ---- model ---------------------------------------------------------------
    c.MODEL = CfgNode()
    c.MODEL.INIT_WEIGHTS = ""
    c.MODEL.BACKBONE = CfgNode()
    c.MODEL.BACKBONE.NAME = ""
    c.MODEL.BACKBONE.PRETRAINED = True
    c.MODEL.HEAD = CfgNode()
    c.MODEL.HEAD.NAME = ""
    c.MODEL.HEAD.HIDDEN_LAYERS = ()
    c.MODEL.HEAD.ACTIVATION = "relu"
    c.MODEL.HEAD.BN = True
    c.MODEL.HEAD.DROPOUT = 0.0

    # ---- optimization ----------------------------------------------------
    c.OPTIM = CfgNode()
    c.OPTIM.NAME = "adam"
    c.OPTIM.LR = 0.0003
    c.OPTIM.WEIGHT_DECAY = 5e-4
    c.OPTIM.MOMENTUM = 0.9
    c.OPTIM.SGD_DAMPNING = 0
    c.OPTIM.SGD_NESTEROV = False
    c.OPTIM.RMSPROP_ALPHA = 0.99
    c.OPTIM.ADAM_BETA1 = 0.9
    c.OPTIM.ADAM_BETA2 = 0.999
    c.OPTIM.STAGED_LR = False
    c.OPTIM.NEW_LAYERS = ()
    c.OPTIM.BASE_LR_MULT = 0.1
    c.OPTIM.LR_SCHEDULER = "single_step"
    c.OPTIM.STEPSIZE = (-1,)
    c.OPTIM.GAMMA = 0.1
    c.OPTIM.MAX_EPOCH = 10
    c.OPTIM.WARMUP_EPOCH = -1
    c.OPTIM.WARMUP_TYPE = "linear"
    c.OPTIM.WARMUP_CONS_LR = 1e-5
    c.OPTIM.WARMUP_MIN_LR = 1e-5
    c.OPTIM.WARMUP_RECOUNT = True

    # ---- train / test ------------------------------------------------------
    c.TRAIN = CfgNode()
    c.TRAIN.CHECKPOINT_FREQ = 0
    c.TRAIN.PRINT_FREQ = 10
    c.TRAIN.COUNT_ITER = "train_x"

    c.TEST = CfgNode()
    c.TEST.EVALUATOR = "Classification"
    c.TEST.PER_CLASS_RESULT = False
    c.TEST.COMPUTE_CMAT = False
    c.TEST.NO_TEST = False
    c.TEST.SPLIT = "test"
    c.TEST.FINAL_MODEL = "last_step"

    # ---- trainer specifics ---------------------------------------------------
    c.TRAINER = CfgNode()
    c.TRAINER.NAME = ""

    c.TRAINER.COOP = CfgNode()
    c.TRAINER.COOP.N_CTX = 16
    c.TRAINER.COOP.CSC = False
    c.TRAINER.COOP.CTX_INIT = ""
    c.TRAINER.COOP.PREC = "fp16"
    c.TRAINER.COOP.CLASS_TOKEN_POSITION = "end"
    c.TRAINER.COOP.VISUAL_TOKEN_PATH = ""

    c.TRAINER.COCOOP = CfgNode()
    c.TRAINER.COCOOP.N_CTX = 16
    c.TRAINER.COCOOP.CTX_INIT = ""
    c.TRAINER.COCOOP.PREC = "fp16"

    # ---- DA trainer hyper-params (reference defaults.py:230-260) ---------
    c.TRAINER.MCD = CfgNode()
    c.TRAINER.MCD.N_STEP_F = 4  # number of steps to train F
    c.TRAINER.MME = CfgNode()
    c.TRAINER.MME.LMDA = 0.1  # weight for the entropy loss
    c.TRAINER.CDAC = CfgNode()
    c.TRAINER.CDAC.CLASS_LR_MULTI = 10
    c.TRAINER.CDAC.RAMPUP_COEF = 30
    c.TRAINER.CDAC.RAMPUP_ITRS = 1000
    c.TRAINER.CDAC.TOPK_MATCH = 5
    c.TRAINER.CDAC.P_THRESH = 0.95
    c.TRAINER.CDAC.STRONG_TRANSFORMS = ()
    c.TRAINER.SE = CfgNode()
    c.TRAINER.SE.EMA_ALPHA = 0.999
    c.TRAINER.SE.CONF_THRE = 0.95
    c.TRAINER.SE.RAMPUP = 300
    c.TRAINER.M3SDA = CfgNode()
    c.TRAINER.M3SDA.LMDA = 0.5  # weight for the moment distance loss
    c.TRAINER.M3SDA.N_STEP_F = 4  # follow MCD
    c.TRAINER.DAEL = CfgNode()
    c.TRAINER.DAEL.WEIGHT_U = 0.5  # weight on the unlabeled loss
    c.TRAINER.DAEL.CONF_THRE = 0.95
    c.TRAINER.DAEL.STRONG_TRANSFORMS = ()

    # ---- DG trainer hyper-params (reference defaults.py:262-289) ---------
    c.TRAINER.CROSSGRAD = CfgNode()
    c.TRAINER.CROSSGRAD.EPS_F = 1.0
    c.TRAINER.CROSSGRAD.EPS_D = 1.0
    c.TRAINER.CROSSGRAD.ALPHA_F = 0.5
    c.TRAINER.CROSSGRAD.ALPHA_D = 0.5
    c.TRAINER.DDAIG = CfgNode()
    c.TRAINER.DDAIG.G_ARCH = ""  # generator architecture (NETWORK_REGISTRY)
    c.TRAINER.DDAIG.LMDA = 0.3  # perturbation weight
    c.TRAINER.DDAIG.CLAMP = False
    c.TRAINER.DDAIG.CLAMP_MIN = -1.0
    c.TRAINER.DDAIG.CLAMP_MAX = 1.0
    c.TRAINER.DDAIG.WARMUP = 0
    c.TRAINER.DDAIG.ALPHA = 0.5
    c.TRAINER.DAELDG = CfgNode()
    c.TRAINER.DAELDG.WEIGHT_U = 0.5
    c.TRAINER.DAELDG.CONF_THRE = 0.95
    c.TRAINER.DAELDG.STRONG_TRANSFORMS = ()
    c.TRAINER.DOMAINMIX = CfgNode()
    c.TRAINER.DOMAINMIX.TYPE = "crossdomain"
    c.TRAINER.DOMAINMIX.ALPHA = 1.0
    c.TRAINER.DOMAINMIX.BETA = 1.0

    # ---- SSL trainer hyper-params (reference defaults.py:291-312) --------
    c.TRAINER.ENTMIN = CfgNode()
    c.TRAINER.ENTMIN.LMDA = 1e-3
    c.TRAINER.MEANTEACHER = CfgNode()
    c.TRAINER.MEANTEACHER.WEIGHT_U = 1.0
    c.TRAINER.MEANTEACHER.EMA_ALPHA = 0.999
    c.TRAINER.MEANTEACHER.RAMPUP = 5  # epochs to ramp up loss_u
    c.TRAINER.MIXMATCH = CfgNode()
    c.TRAINER.MIXMATCH.WEIGHT_U = 100.0
    c.TRAINER.MIXMATCH.TEMP = 2.0
    c.TRAINER.MIXMATCH.MIXUP_BETA = 0.75
    c.TRAINER.MIXMATCH.RAMPUP = 20000  # steps to ramp up loss_u
    c.TRAINER.FIXMATCH = CfgNode()
    c.TRAINER.FIXMATCH.WEIGHT_U = 1.0
    c.TRAINER.FIXMATCH.CONF_THRE = 0.95
    c.TRAINER.FIXMATCH.STRONG_TRANSFORMS = ()

    # ---- OVMR top-level extensions (reference train.py:100-132) --------------
    c.FS_CLASSIFIER = "metaopt"
    c.CLASSIFIER_PARAMETERS = []
    c.STAGE_NUM = 1
    c.USE_CLIP_TEXT = False
    c.EVAL_MODE = "multimodal"  # text | vision | multimodal | fusion
    c.EVAL_TAU = 10

    # ---- device extensions (no reference counterpart) -----------------------
    # The JAX package's TPU node, narrowed to what applies on a CUDA card
    c.CUDA = CfgNode()
    # the device the trainer runs on: "cuda" (the hand-written kernels) or
    # "cpu" (their plain PyTorch twins); "cuda" with no card raises
    c.CUDA.DEVICE = "cuda"
    # compute dtype of the frozen towers: bfloat16, float16 or float32
    c.CUDA.DTYPE = "bfloat16"
    c.CUDA.MESH = CfgNode()
    # model-axis size of the serving seams; training takes 1 only
    c.CUDA.MESH.MODEL = 1
    # pad per-dataset class counts up to multiples of this for classifier
    # generation's chunks
    c.CUDA.CLASS_PAD_MULTIPLE = 8
    # classifier generation processes classes in chunks of this size when
    # the class count exceeds it (bounds text-tower activation memory)
    c.CUDA.CLASS_CHUNK = 2048
    # eval batches ship as uint8 and are normalised on the device (4x
    # smaller host->device copies; the same numbers as the float path)
    c.CUDA.EVAL_UINT8_TRANSFER = True
    # skip the frozen zero-shot text classifier at or above this many
    # classes (the reference's >=5000 guard, ``mm_…:118-126``); the
    # artifact then omits text_classifier/fusion_weight and the text/fusion
    # eval modes refuse
    c.CUDA.TEXT_CLS_MAX_CLASSES = 5000
    # training input path of decode-once uint8 caches augmented on the
    # device (not ported yet: True raises)
    c.CUDA.DEVICE_AUGS = False
    # cache side for that decode-once store
    c.CUDA.CACHE_SIDE = 256

    return c


# TPU.<key> of the JAX package's configs read onto CUDA.<key>
TPU_KEYS_ONTO_CUDA = (
    "DTYPE",
    "MESH.MODEL",
    "CLASS_PAD_MULTIPLE",
    "CLASS_CHUNK",
    "EVAL_UINT8_TRANSFER",
    "TEXT_CLS_MAX_CLASSES",
    "DEVICE_AUGS",
    "CACHE_SIDE",
)
# TPU.<key> with no CUDA twin, and the JAX package's default, the only
# value the port accepts for it
TPU_KEYS_AT_DEFAULT = {
    "MESH.DATA": -1,
    "MULTIHOST_SLICED_LOADER": True,
    "USE_PALLAS_ATTENTION": False,
    "USE_FUSED_BLOCK": True,
    "INT8": False,
    "TP_SPLIT_QKV": True,
    "CHECKPOINT_BACKEND": "npz",
}


def extend_cfg(cfg: CfgNode) -> CfgNode:
    """Kept for CLI parity with the reference; defaults already include the
    OVMR extensions, so this is a no-op hook."""
    return cfg
