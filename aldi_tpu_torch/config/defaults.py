"""Default configuration tree (a copy of ``aldi_tpu/config/defaults.py``).

The port keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_port_serving.py`` holds the two trees equal on every
shipped YAML. This single tree covers everything the reference stack splits across
Detectron2's defaults and the DA additions (reference ``aldi/config.py:7-100``
adds the DOMAIN_ADAPT/EMA/AUG/SOLVER extras to D2's tree; we own the whole
substrate so there is one place). Every key consumed by the reference's 31
shipped YAML configs resolves here, so those configs load unmodified.

DA-specific features are all disabled by default, matching the reference's
"everything must be explicitly enabled" stance (``aldi/config.py:1-2``).

Keys under ``TPU`` describe the static-shape contract (fixed image canvas,
padded GT/detection counts) and the JAX package's device mesh. The port reads
``TPU.CANVAS`` and ``TPU.COMPUTE_DTYPE``; the other ``TPU`` keys are kept so
that every config loads unchanged.
"""

from .cfg_node import CfgNode as CN


def get_default_cfg() -> CN:
    _C = CN()
    _C.VERSION = 2
    _C.OUTPUT_DIR = "./output"
    _C.SEED = -1
    _C.VIS_PERIOD = 0
    _C.CUDNN_BENCHMARK = False

    # ------------------------------------------------------------- MODEL
    _C.MODEL = CN()
    _C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    _C.MODEL.DEVICE = "tpu"
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.MASK_ON = False
    _C.MODEL.KEYPOINT_ON = False
    _C.MODEL.LOAD_PROPOSALS = False
    # image normalization; reference uses BGR Caffe-style means
    _C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]
    _C.MODEL.YAML = ""  # YOLO architecture yaml identifier

    _C.MODEL.BACKBONE = CN()
    _C.MODEL.BACKBONE.NAME = "build_resnet_fpn_backbone"
    _C.MODEL.BACKBONE.FREEZE_AT = 2

    _C.MODEL.RESNETS = CN()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res4"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True
    _C.MODEL.RESNETS.RES5_DILATION = 1
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64

    _C.MODEL.FPN = CN()
    _C.MODEL.FPN.IN_FEATURES = []
    _C.MODEL.FPN.OUT_CHANNELS = 256
    _C.MODEL.FPN.NORM = ""
    _C.MODEL.FPN.FUSE_TYPE = "sum"

    _C.MODEL.ANCHOR_GENERATOR = CN()
    _C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    _C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    _C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

    _C.MODEL.PROPOSAL_GENERATOR = CN()
    _C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
    _C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

    _C.MODEL.RPN = CN()
    _C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
    _C.MODEL.RPN.IN_FEATURES = ["res4"]
    _C.MODEL.RPN.BOUNDARY_THRESH = -1
    _C.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
    _C.MODEL.RPN.IOU_LABELS = [0, -1, 1]
    _C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    _C.MODEL.RPN.POSITIVE_FRACTION = 0.5
    _C.MODEL.RPN.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    _C.MODEL.RPN.SMOOTH_L1_BETA = 0.0
    _C.MODEL.RPN.LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
    _C.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
    _C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
    _C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    _C.MODEL.RPN.NMS_THRESH = 0.7
    _C.MODEL.RPN.CONV_DIMS = [-1]

    _C.MODEL.ROI_HEADS = CN()
    _C.MODEL.ROI_HEADS.NAME = "Res5ROIHeads"
    _C.MODEL.ROI_HEADS.NUM_CLASSES = 80
    _C.MODEL.ROI_HEADS.IN_FEATURES = ["res4"]
    _C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
    _C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
    _C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    _C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    _C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    _C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    _C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True

    _C.MODEL.ROI_BOX_HEAD = CN()
    _C.MODEL.ROI_BOX_HEAD.NAME = ""
    _C.MODEL.ROI_BOX_HEAD.NUM_FC = 0
    _C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    _C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_BOX_HEAD.NORM = ""
    _C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    _C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    _C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    _C.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False

    _C.MODEL.ROI_MASK_HEAD = CN()
    _C.MODEL.ROI_MASK_HEAD.NAME = ""
    _C.MODEL.ROI_MASK_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14

    # ConvNeXt backbone (defaults = ConvNeXt-T; reference aldi/config.py:92-99)
    _C.MODEL.CONVNEXT = CN()
    _C.MODEL.CONVNEXT.DEPTHS = [3, 3, 9, 3]
    _C.MODEL.CONVNEXT.DIMS = [96, 192, 384, 768]
    _C.MODEL.CONVNEXT.DROP_PATH_RATE = 0.2
    _C.MODEL.CONVNEXT.LAYER_SCALE_INIT_VALUE = 1e-6
    _C.MODEL.CONVNEXT.OUT_FEATURES = [0, 1, 2, 3]

    # YOLOv5 head/loss hyperparameters (reference configs/Base-Yolo.yaml:4-15)
    _C.MODEL.YOLO = CN()
    _C.MODEL.YOLO.NUM_CLASSES = 80
    _C.MODEL.YOLO.FOCAL_LOSS_GAMMA = 0.0
    _C.MODEL.YOLO.BOX_LOSS_GAIN = 0.05
    _C.MODEL.YOLO.CLS_LOSS_GAIN = 0.3
    _C.MODEL.YOLO.CLS_POSITIVE_WEIGHT = 1.0
    _C.MODEL.YOLO.OBJ_LOSS_GAIN = 0.7
    _C.MODEL.YOLO.OBJ_POSITIVE_WEIGHT = 1.0
    _C.MODEL.YOLO.LABEL_SMOOTHING = 0.0
    _C.MODEL.YOLO.ANCHOR_T = 4.0
    _C.MODEL.YOLO.CONF_THRESH = 0.001
    _C.MODEL.YOLO.IOU_THRES = 0.65

    # Deformable DETR (reference configs/Base-DETR.yaml:7-39)
    _C.MODEL.DEFORMABLE_DETR = CN()
    _C.MODEL.DEFORMABLE_DETR.BACKBONE = "resnet50"
    _C.MODEL.DEFORMABLE_DETR.DILATION = False
    _C.MODEL.DEFORMABLE_DETR.FROZEN_WEIGHTS = None
    _C.MODEL.DEFORMABLE_DETR.NUM_CLASSES = 80
    _C.MODEL.DEFORMABLE_DETR.NUM_FEATURE_LEVELS = 4
    _C.MODEL.DEFORMABLE_DETR.POSITION_EMBEDDING = "sine"
    _C.MODEL.DEFORMABLE_DETR.POSITION_EMBEDDING_SCALE = 6.283185307179586
    _C.MODEL.DEFORMABLE_DETR.TWO_STAGE = False
    _C.MODEL.DEFORMABLE_DETR.WITH_BOX_REFINE = False
    # layer-level remat for the transformer (off: the inner checkpoint in
    # ms_deform_attn_core already bounds the gather temporaries; enable for
    # canvases far beyond 640^2 where Lq-scaled residuals stop fitting HBM)
    _C.MODEL.DEFORMABLE_DETR.USE_ACT_CHECKPOINT = False
    _C.MODEL.DEFORMABLE_DETR.TRANSFORMER = CN()
    _C.MODEL.DEFORMABLE_DETR.TRANSFORMER.ENC_LAYERS = 6
    _C.MODEL.DEFORMABLE_DETR.TRANSFORMER.DEC_LAYERS = 6
    _C.MODEL.DEFORMABLE_DETR.TRANSFORMER.DIM_FEEDFORWARD = 1024
    _C.MODEL.DEFORMABLE_DETR.TRANSFORMER.HIDDEN_DIM = 256
    _C.MODEL.DEFORMABLE_DETR.TRANSFORMER.DROPOUT = 0.1
    _C.MODEL.DEFORMABLE_DETR.TRANSFORMER.NHEADS = 8
    _C.MODEL.DEFORMABLE_DETR.TRANSFORMER.NUM_QUERIES = 300
    _C.MODEL.DEFORMABLE_DETR.TRANSFORMER.ENC_N_POINTS = 4
    _C.MODEL.DEFORMABLE_DETR.TRANSFORMER.DEC_N_POINTS = 4
    _C.MODEL.DEFORMABLE_DETR.MATCHER = CN()
    _C.MODEL.DEFORMABLE_DETR.MATCHER.SET_COST_CLASS = 2.0
    _C.MODEL.DEFORMABLE_DETR.MATCHER.SET_COST_BBOX = 5.0
    _C.MODEL.DEFORMABLE_DETR.MATCHER.SET_COST_GIOU = 2.0
    _C.MODEL.DEFORMABLE_DETR.LOSS = CN()
    _C.MODEL.DEFORMABLE_DETR.LOSS.AUX_LOSS = True
    _C.MODEL.DEFORMABLE_DETR.LOSS.CLS_LOSS_COEF = 2.0
    _C.MODEL.DEFORMABLE_DETR.LOSS.BBOX_LOSS_COEF = 5.0
    _C.MODEL.DEFORMABLE_DETR.LOSS.GIOU_LOSS_COEF = 2.0
    _C.MODEL.DEFORMABLE_DETR.LOSS.MASK_LOSS_COEF = 1.0
    _C.MODEL.DEFORMABLE_DETR.LOSS.DICE_LOSS_COEF = 1.0
    _C.MODEL.DEFORMABLE_DETR.LOSS.FOCAL_ALPHA = 0.25

    # ------------------------------------------------------------- INPUT
    _C.INPUT = CN()
    _C.INPUT.MIN_SIZE_TRAIN = (800,)
    _C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 800
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.RANDOM_FLIP = "horizontal"
    _C.INPUT.FORMAT = "BGR"
    _C.INPUT.MASK_FORMAT = "polygon"
    _C.INPUT.CROP = CN()
    _C.INPUT.CROP.ENABLED = False
    _C.INPUT.CROP.TYPE = "relative_range"
    _C.INPUT.CROP.SIZE = [0.9, 0.9]

    # ------------------------------------------------------------- DATA
    _C.DATASETS = CN()
    _C.DATASETS.TRAIN = tuple()
    _C.DATASETS.TEST = tuple()
    # precomputed proposals (substrate parity; consumed when
    # MODEL.LOAD_PROPOSALS — see data/proposals.py)
    _C.DATASETS.PROPOSAL_FILES_TRAIN = tuple()
    _C.DATASETS.PROPOSAL_FILES_TEST = tuple()
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000
    # DA additions (reference aldi/config.py:10-13)
    _C.DATASETS.UNLABELED = tuple()
    _C.DATASETS.BATCH_CONTENTS = ("labeled_weak",)
    _C.DATASETS.BATCH_RATIOS = (1,)

    _C.DATALOADER = CN()
    _C.DATALOADER.NUM_WORKERS = 4
    _C.DATALOADER.ASPECT_RATIO_GROUPING = True
    _C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
    _C.DATALOADER.REPEAT_THRESHOLD = 0.0
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    # ------------------------------------------------------------- AUG (DA)
    # reference aldi/config.py:15-23
    _C.AUG = CN()
    _C.AUG.WEAK_INCLUDES_MULTISCALE = True
    _C.AUG.LABELED_INCLUDE_RANDOM_ERASING = True
    _C.AUG.UNLABELED_INCLUDE_RANDOM_ERASING = True
    _C.AUG.LABELED_MIC_AUG = False
    _C.AUG.UNLABELED_MIC_AUG = False
    _C.AUG.MIC_RATIO = 0.5
    _C.AUG.MIC_BLOCK_SIZE = 32

    # ------------------------------------------------------------- EMA (DA)
    # reference aldi/config.py:25-33
    _C.EMA = CN()
    _C.EMA.ENABLED = False
    _C.EMA.ALPHA = 0.9996
    _C.EMA.LOAD_FROM_EMA_ON_START = True
    _C.EMA.START_ITER = 0

    # ----------------------------------------------------- DOMAIN_ADAPT (DA)
    # reference aldi/config.py:35-73
    _C.DOMAIN_ADAPT = CN()
    _C.DOMAIN_ADAPT.ALIGN = CN()
    _C.DOMAIN_ADAPT.ALIGN.MIXIN_NAME = "AlignMixin"
    _C.DOMAIN_ADAPT.ALIGN.IMG_DA_ENABLED = False
    _C.DOMAIN_ADAPT.ALIGN.IMG_DA_LAYER = "p2"
    _C.DOMAIN_ADAPT.ALIGN.IMG_DA_WEIGHT = 0.01
    _C.DOMAIN_ADAPT.ALIGN.IMG_DA_INPUT_DIM = 256
    _C.DOMAIN_ADAPT.ALIGN.IMG_DA_HIDDEN_DIMS = [256]
    _C.DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED = False
    _C.DOMAIN_ADAPT.ALIGN.INS_DA_WEIGHT = 0.01
    _C.DOMAIN_ADAPT.ALIGN.INS_DA_INPUT_DIM = 1024
    _C.DOMAIN_ADAPT.ALIGN.INS_DA_HIDDEN_DIMS = [1024]

    _C.DOMAIN_ADAPT.DISTILL = CN()
    _C.DOMAIN_ADAPT.DISTILL.DISTILLER_NAME = "ALDIDistiller"
    _C.DOMAIN_ADAPT.DISTILL.MIXIN_NAME = "DistillMixin"
    _C.DOMAIN_ADAPT.DISTILL.HARD_ROIH_CLS_ENABLED = False
    _C.DOMAIN_ADAPT.DISTILL.HARD_ROIH_REG_ENABLED = False
    _C.DOMAIN_ADAPT.DISTILL.HARD_OBJ_ENABLED = False
    _C.DOMAIN_ADAPT.DISTILL.HARD_RPN_REG_ENABLED = False
    _C.DOMAIN_ADAPT.DISTILL.ROIH_CLS_ENABLED = False
    _C.DOMAIN_ADAPT.DISTILL.ROIH_REG_ENABLED = False
    _C.DOMAIN_ADAPT.DISTILL.OBJ_ENABLED = False
    _C.DOMAIN_ADAPT.DISTILL.RPN_REG_ENABLED = False
    _C.DOMAIN_ADAPT.DISTILL.CLS_TMP = 1.0
    _C.DOMAIN_ADAPT.DISTILL.OBJ_TMP = 1.0
    _C.DOMAIN_ADAPT.CLS_LOSS_TYPE = "CE"

    _C.DOMAIN_ADAPT.TEACHER = CN()
    _C.DOMAIN_ADAPT.TEACHER.ENABLED = False
    _C.DOMAIN_ADAPT.TEACHER.THRESHOLD = 0.8

    # ------------------------------------------------------------- ViT
    _C.VIT = CN()
    _C.VIT.USE_ACT_CHECKPOINT = True

    # ------------------------------------------------------------- SOLVER
    _C.SOLVER = CN()
    _C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
    _C.SOLVER.MAX_ITER = 40000
    _C.SOLVER.BASE_LR = 0.001
    _C.SOLVER.BASE_LR_END = 0.0
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.NESTEROV = False
    _C.SOLVER.WEIGHT_DECAY = 0.0001
    _C.SOLVER.WEIGHT_DECAY_NORM = 0.0
    _C.SOLVER.WEIGHT_DECAY_BIAS = None
    _C.SOLVER.BIAS_LR_FACTOR = 1.0
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (30000,)
    _C.SOLVER.WARMUP_FACTOR = 0.001
    _C.SOLVER.WARMUP_ITERS = 1000
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.CHECKPOINT_PERIOD = 5000
    _C.SOLVER.IMS_PER_BATCH = 16
    _C.SOLVER.REFERENCE_WORLD_SIZE = 0
    _C.SOLVER.CLIP_GRADIENTS = CN()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
    _C.SOLVER.AMP = CN()
    _C.SOLVER.AMP.ENABLED = False
    # DA additions (reference aldi/config.py:79-90)
    _C.SOLVER.IMS_PER_GPU = 2
    _C.SOLVER.BACKWARD_AT_END = True
    _C.SOLVER.OPTIMIZER = "SGD"
    _C.SOLVER.WEIGHT_DECAY_RATE = 0.95
    # DETR per-group LR (reference configs/Base-DETR.yaml:62-70)
    _C.SOLVER.BACKBONE_LR_MULTIPLIER = 0.1
    _C.SOLVER.LR_BACKBONE_NAMES = ["backbone.0"]
    _C.SOLVER.LR_LINEAR_PROJ_MULTIPLIER = 0.1
    _C.SOLVER.LR_LINEAR_PROJ_NAMES = ["reference_points", "sampling_offsets"]

    # ------------------------------------------------------------- TEST
    _C.TEST = CN()
    _C.TEST.EVAL_PERIOD = 0
    _C.TEST.DETECTIONS_PER_IMAGE = 100
    _C.TEST.EXPECTED_RESULTS = []

    # ------------------------------------------------------------- TPU
    # Static-shape contract shared with the JAX package.
    _C.TPU = CN()
    # Fixed image canvas (H, W). (0, 0) = derive from INPUT sizes at build time.
    _C.TPU.CANVAS = (0, 0)
    # Padded count of GT boxes per image (extra boxes dropped, short ones masked)
    _C.TPU.MAX_GT = 100
    # Compute dtype: "bfloat16" when SOLVER.AMP.ENABLED else "float32";
    # set explicitly to override.
    _C.TPU.COMPUTE_DTYPE = ""
    # JAX-package settings (device mesh, gradient accumulation, host
    # pipeline, ROIAlign and RPN-loss formulations, profiling); the port
    # does not read them yet.
    _C.TPU.MESH_DATA = 0
    _C.TPU.MESH_MODEL = 1
    _C.TPU.FSDP = False
    _C.TPU.GRAD_ACCUM = 1
    _C.TPU.DATA_THREADS = 8
    _C.TPU.POOL_MODE = "auto"
    _C.TPU.EVAL_POOL_MODE = "auto"
    _C.TPU.RPN_LOSS_IMPL = "sampled"
    _C.TPU.PROFILE_DIR = ""
    _C.TPU.PREFETCH = 2
    _C.TPU.DEVICE_PREFETCH = 2

    return _C
