"""Default config schema.

The PyTorch port's own copy of the schema, key for key (ref:
configs/default.py:7-210), so reference YAML files (configs/17/model_RSN.yaml
etc.) parse unchanged in both packages.  The ``TPU`` section keeps its name
so the same files load; the port reads ``TPU.COMPUTE_DTYPE`` and
``TPU.PARAM_DTYPE`` from it.
"""

from otpose_tpu_torch.config.node import CfgNode

_C = CfgNode()
_C.DETECTOR_NAME = ""
_C.ROOT_DIR = ""
_C.EXPERIMENT_NAME = ""
_C.OUTPUT_DIR = ""
_C.SAVE_HEATMAPS = False
_C.LOAD_HEATMAPS = False
_C.SAVE_PREDS = False
_C.PREDS_SFX = ""
_C.LOAD_PREDS = False
_C.SAVE_OFFSETS = False
_C.LOG_DIR = ""
_C.DATA_DIR = ""
_C.MODEL_DIR = ""
_C.GPUS = (0,)  # accepted for reference-yaml compat; the port runs on one CUDA device
_C.WORKERS = 8
_C.PRINT_FREQ = 20
_C.PIN_MEMORY = True
_C.RANK = 0

_C.DISTANCE_WHOLE_OTHERWISE_SEGMENT = True
_C.DISTANCE = 2
_C.PREVIOUS_DISTANCE = 1
_C.NEXT_DISTANCE = 1
_C.CORE_FUNCTION = ""
_C.SEED = 8888

_C.EVAL_TRACKING = False
_C.TRACK_PREDS_FILE = ""
_C.TRACKING_THRESHOLD = 0.5

# Accepted for reference-yaml compat; the port does not read them.
_C.CUDNN = CfgNode()
_C.CUDNN.BENCHMARK = True
_C.CUDNN.DETERMINISTIC = False
_C.CUDNN.ENABLED = True

#### MODEL ####
_C.MODEL = CfgNode()
_C.MODEL.NAME = "pose_hrnet"
_C.MODEL.DEVICE = "tpu"
_C.MODEL.INIT_WEIGHTS = True
_C.MODEL.FREEZE_WEIGHTS = False
_C.MODEL.PRETRAINED = ""
_C.MODEL.PRETRAINED_HRNET = ""
_C.MODEL.NUM_JOINTS = 17
_C.MODEL.EFFECTIVE_NUM_JOINTS = 15
_C.MODEL.TARGET_TYPE = "gaussian"
_C.MODEL.IMAGE_SIZE = [256, 256]  # width * height
_C.MODEL.HEATMAP_SIZE = [64, 64]  # width * height
_C.MODEL.SIGMA = 2
_C.MODEL.EXTRA = CfgNode(new_allowed=True)
_C.MODEL.CYCLE_CONSISTENCY_FINETUNE = False
_C.MODEL.DEFORAM_CONV_VERSION = 1
_C.MODEL.DEFORMABLE_CONV = CfgNode(new_allowed=True)
_C.MODEL.USE_RECTIFIER = True
_C.MODEL.USE_MARGIN = True
_C.MODEL.USE_GROUP = True
_C.MODEL.HIGH_RESOLUTION = False
_C.MODEL.FREEZE_HRNET_WEIGHTS = False
_C.MODEL.MPII_PRETRAINED = False
_C.MODEL.USE_WARPING_TRAIN = True
_C.MODEL.USE_WARPING_TEST = True
_C.MODEL.WARPING_REVERSE = False
_C.MODEL.USE_GT_INPUT_TEST = False
_C.MODEL.USE_GT_INPUT_TRAIN = False
_C.MODEL.ITER = 30000
_C.MODEL.EVALUATE = True
_C.MODEL.DILATION_EXP = 0
_C.MODEL.VISUALIZE_OFFSETS = False
_C.MODEL.USE_PRF = True
_C.MODEL.PRF_BASICBLOCK_NUM = 10
_C.MODEL.PRF_INNER_CH = 12
_C.MODEL.USE_PTM = True
_C.MODEL.PTM_BASICBLOCK_NUM = 10
_C.MODEL.PTM_INNER_CH = 12
_C.MODEL.PRF_PTM_COMBINE_INNER_CH = 10
_C.MODEL.PRF_PTM_COMBINE_BASICBLOCK_NUM = 10
_C.MODEL.USE_PCN = True
_C.MODEL.DEFORMABLE_CONV_CH = 64
_C.MODEL.OFFSET_MASK_COMBINE_CONV = 2

#### LOSS ####
_C.LOSS = CfgNode()
_C.LOSS.NAME = "ST_OHKW_MSELoss"
_C.LOSS.USE_OHKM = False
_C.LOSS.TOPK = 8
_C.LOSS.USE_TARGET_WEIGHT = True
_C.LOSS.USE_DIFFERENT_JOINTS_WEIGHT = False
_C.LOSS.USE_SOFTARGMAX = False

#### DATASET ####
_C.DATASET = CfgNode()
_C.DATASET.RANDOM_AUX_FRAME = True
_C.DATASET.ROOT = ""
_C.DATASET.NAME = ""
_C.DATASET.DATASET = "mpii"
_C.DATASET.TRAIN_SET = "train"
_C.DATASET.TEST_SET = "valid"
_C.DATASET.HYBRID_JOINTS_TYPE = ""
_C.DATASET.SELECT_DATA = False
_C.DATASET.TEST_ON_TRAIN = False
_C.DATASET.JSON_FILE = ""
_C.DATASET.JSON_DIR = ""
_C.DATASET.POSETRACK17_JSON_DIR = ""
_C.DATASET.POSETRACK18_JSON_DIR = ""
_C.DATASET.IMG_DIR = ""
_C.DATASET.POSETRACK17_IMG_DIR = ""
_C.DATASET.POSETRACK18_IMG_DIR = ""
_C.DATASET.IS_2018 = False
_C.DATASET.COLOR_RGB = False
_C.DATASET.TEST_IMG_DIR = ""
_C.DATASET.POSETRACK17_TEST_IMG_DIR = ""
_C.DATASET.POSETRACK18_TEST_IMG_DIR = ""
_C.DATASET.INPUT_TYPE = ""
_C.DATASET.BBOX_ENLARGE_FACTOR = 1.0

#### TRAIN ####
_C.TRAIN = CfgNode()
_C.TRAIN.SAVE_MODEL_PER_EPOCH = 2
_C.TRAIN.BATCH_SIZE_PER_GPU = 32
_C.TRAIN.SHUFFLE = True
_C.TRAIN.LOSS_ALPHA = 1.0
_C.TRAIN.LOSS_BETA = 1.0
_C.TRAIN.LOSS_GAMA = 1.0
_C.TRAIN.LR_FACTOR = 0.1
_C.TRAIN.LR_STEP = [90, 110]
_C.TRAIN.MILESTONES = [8, 12, 16]
_C.TRAIN.GAMMA = 0.99
_C.TRAIN.LR = 0.001
_C.TRAIN.LR_END = 0.00001
_C.TRAIN.STSN_LR = 0.001
_C.TRAIN.OPTIMIZER = "AdamW"
_C.TRAIN.MOMENTUM = 0.9
_C.TRAIN.WD = 0.05
_C.TRAIN.NESTEROV = False  # parsed-but-ignored, as in the reference (its
# make_optimizer never passes nesterov to optim.SGD, train_utils.py:124-128)
_C.TRAIN.GAMMA1 = 0.99
_C.TRAIN.GAMMA2 = 0.0
_C.TRAIN.BEGIN_EPOCH = 0
_C.TRAIN.END_EPOCH = 140
_C.TRAIN.AUTO_RESUME = False
_C.TRAIN.FLIP = True
_C.TRAIN.SCALE_FACTOR = [0.25, 0.25]
_C.TRAIN.ROT_FACTOR = 30
_C.TRAIN.PROB_HALF_BODY = 0.0
_C.TRAIN.NUM_JOINTS_HALF_BODY = 8
_C.TRAIN.LR_SCHEDULER = "CosineAnnealingLR"
_C.TRAIN.EPOCHS = 30
_C.TRAIN.WARMUP = True
_C.TRAIN.WARMUP_EPOCHS = 12

#### VAL ####
_C.VAL = CfgNode()
_C.VAL.BATCH_SIZE_PER_GPU = 1
_C.VAL.MODEL_FILE = ""
_C.VAL.ANNOT_DIR = ""
_C.VAL.COCO_BBOX_FILE = ""
_C.VAL.USE_GT_BBOX = False
_C.VAL.FLIP_VAL = False
_C.VAL.BBOX_THRE = 1.0
_C.VAL.IMAGE_THRE = 0.1
_C.VAL.IN_VIS_THRE = 0.0
_C.VAL.NMS_THRE = 0.6
_C.VAL.OKS_THRE = 0.5
_C.VAL.SHIFT_HEATMAP = False
_C.VAL.SOFT_NMS = False
_C.VAL.POST_PROCESS = False

#### TEST ####
_C.TEST = CfgNode()
_C.TEST.BATCH_SIZE_PER_GPU = 1
_C.TEST.MODEL_FILE = ""
_C.TEST.ANNOT_DIR = ""
_C.TEST.COCO_BBOX_FILE = ""
_C.TEST.USE_GT_BBOX = False
_C.TEST.FLIP_TEST = False
_C.TEST.BBOX_THRE = 1.0
_C.TEST.IMAGE_THRE = 0.1
_C.TEST.IN_VIS_THRE = 0.0
_C.TEST.NMS_THRE = 0.6
_C.TEST.OKS_THRE = 0.5
_C.TEST.SHIFT_HEATMAP = False
_C.TEST.SOFT_NMS = False
_C.TEST.POST_PROCESS = False

#### INFERENCE ####
_C.INFERENCE = CfgNode()
_C.INFERENCE.MODEL_FILE = ""

#### DEBUG ####
_C.DEBUG = CfgNode()
_C.DEBUG.VIS_SKELETON = False
_C.DEBUG.VIS_BBOX = False
_C.DEBUG.VIS_TENSORBOARD = False
_C.DEBUG.DEBUG = False
_C.DEBUG.SAVE_BATCH_IMAGES_GT = False
_C.DEBUG.SAVE_BATCH_IMAGES_PRED = False
_C.DEBUG.SAVE_HEATMAPS_GT = False
_C.DEBUG.SAVE_HEATMAPS_PRED = False

#### TPU (new: no reference counterpart) ####
_C.TPU = CfgNode()
_C.TPU.MESH_AXES = ["data"]          # mesh axis names; batch is sharded on 'data'
_C.TPU.MESH_SHAPE = [-1]             # -1 = all available devices on that axis
_C.TPU.COMPUTE_DTYPE = "bfloat16"    # matmul/conv compute dtype; params stay f32
# eval-time parameter dtype: "bfloat16" halves param HBM traffic for eval/
# inference (training always keeps f32 master params)
_C.TPU.PARAM_DTYPE = "float32"
# NOTE on sync-BN: there is no knob because the jit'd train step computes
# batch-norm statistics over the *global* (mesh-wide) batch by construction —
# sync-BN semantics are always on (documented divergence from DataParallel's
# per-replica stats; see engine/trainer.py docstring).
_C.TPU.PREFETCH_DEPTH = 2            # host->device pipeline depth
_C.TPU.DONATE_STATE = True           # donate train-state buffers to the jit step
_C.TPU.REMAT = False                 # recompute forward in backward (bigger batches)
# gradient accumulation: split each TRAIN.BATCH_SIZE_PER_GPU batch into K
# sequential micro-batches (lax.scan) with one optimizer update — effective
# batches beyond 16GB HBM without remat's recompute cost (engine/trainer.py)
_C.TPU.ACCUM_STEPS = 1
# NOTE: no Pallas knob — the deformable-conv battery ships as the gather-free
# tent-matmul XLA formulation (ops/deform_conv.py), which measures within
# ~25% of the fused-VMEM floor on v5e; two Pallas kernels (dense-tent and
# shift-decomposition) were built, benchmarked slower, and removed.  See
# STATUS.md "Deform kernel analysis".
_C.TPU.PROFILE_DIR = ""              # non-empty: capture jax.profiler traces here
# device preprocessing: auto | off | crops | full.
#   crops: host warps uint8 crops (minimal host->device bytes); device does
#          normalize + temporal assembly + target generation
#   full:  device also does the 5-frame warp (separable matmul) from staged
#          raw frames — for co-located hosts where shipping pixels is cheap
#   auto:  crops when the default backend is an accelerator, else off
_C.TPU.DEVICE_PREPROCESS = "auto"
_C.TPU.MAX_FRAME_HW = [1088, 1920]   # raw-frame staging buffer (covers PoseTrack)
# multi-host jobs (one process per host): true = jax.distributed.initialize()
# pod auto-detection; explicit coordinators use OTPOSE_COORDINATOR /
# OTPOSE_NUM_PROCESSES / OTPOSE_PROCESS_ID env vars instead
# (parallel/distributed.py)
_C.TPU.MULTIHOST = False
# overlap per-epoch checkpoint serialization with the validation pass that
# follows it (orbax async commit; single-process only — multihost saves
# need every process at the same barrier, engine/checkpoints.py)
_C.TPU.ASYNC_CHECKPOINT = True


def get_cfg() -> CfgNode:
    """Return a fresh clone of the default config (ref: utils/setup.py:97-106)."""
    return _C.clone()
