"""Default config tree — the port's own copy of ``divergen_tpu/config/defaults.py``.

Every key and default equals the JAX package's (``tests/test_torch_config.py``
compares the dumps), so the reference YAML files merge into both. Of this
tree the port reads the model and test keys that ``build_model`` and the
``from_cfg`` constructors name; ``MODEL.DEVICE`` is not one of them, the
device of an entry point comes from ``utils.dist.entry_device``.

Mirrors, in one place, the three layers of the reference config:
  * detectron2 defaults (BSGAL/third_party/CenterNet2/detectron2/config/defaults.py)
  * ``add_centernet_config`` (CenterNet2/centernet/config.py, 75 flags)
  * ``add_divergen_config`` / ``add_bsgal_config``
    (DiverGen/divergen/config.py:4-209, BSGAL/bsgal/config.py:4-220)

Flags this build does not consume yet are still declared so reference
YAML configs merge cleanly; consumers assert on the subset they read.
"""
from __future__ import annotations

from .config import ConfigNode


def get_cfg() -> ConfigNode:
    c = ConfigNode()
    c.VERSION = 2
    c.OUTPUT_DIR = "./output"
    c.SEED = 42
    c.PROFILE_START_ITER = -1  # >=0: profiler trace window start
    c.PROFILE_NUM_ITERS = 5
    c.FP16 = False  # bf16 compute dtype (ref: cfg.FP16, train_net.py:277)
    c.FIND_UNUSED_PARAM = True  # DDP flag of the reference (train_net.py:357)
    c.DEBUG = False
    c.SAVE_DEBUG = False
    c.SAVE_PTH = False
    c.VIS_THRESH = 0.3
    c.DEBUG_SHOW_NAME = False
    c.GEN_PSEDO_LABELS = False
    c.QUICK_DEBUG = False
    c.EVAL_CACHE = False
    c.EVAL_AP_FIX = False
    c.EVAL_PROPOSAL_AR = False
    c.EVAL_CAT_SPEC_AR = False
    c.IS_DEBUG = False
    c.WITH_IMAGE_LABELS = False  # co-train with image-labeled data (reference config.py:7)

    # ---------------- MODEL ----------------
    m = c.MODEL = ConfigNode()
    m.DEVICE = "tpu"
    m.META_ARCHITECTURE = "CustomRCNN"
    m.MASK_ON = True
    m.KEYPOINT_ON = False
    m.PIXEL_MEAN = [123.675, 116.28, 103.53]
    m.PIXEL_STD = [58.395, 57.12, 57.375]
    m.WEIGHTS = ""
    m.SYNC_CAPTION_BATCH = False
    # per-test-set zero-shot classifier swap (ref config.py:56-59 +
    # train_net.py:89-93): TEST_CLASSIFIERS[d] is a (zs_dim, C_d) .npy
    m.RESET_CLS_TESTS = False
    m.TEST_CLASSIFIERS = []
    m.TEST_NUM_CLASSES = []
    m.WITH_CAPTION = False
    m.CAP_BATCH_RATIO = 4
    m.DYNAMIC_CLASSIFIER = False
    m.DATASET_LOSS_WEIGHT = []  # per-dataset loss scale (custom_rcnn.py:197-202)
    # ablation switches: False restores the X-Paste instance_source loss
    # masking (detic_fast_rcnn.py:154, consumed via cfg.MODEL.get)
    m.USE_DIVERGEN_BOX_LOSS = True
    m.USE_DIVERGEN_MASK_LOSS = True
    m.USE_XPASTE_BOX_LOSS = True
    m.USE_XPASTE_MASK_LOSS = True
    m.NUM_SAMPLE_CATS = 50
    m.ROI_BOX_HEAD_2 = ConfigNode()

    m.BACKBONE = ConfigNode()
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.BACKBONE.FREEZE_AT = 0

    m.FPN = ConfigNode()
    m.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 256
    m.FPN.NORM = ""
    m.FPN.FUSE_TYPE = "sum"

    m.RESNETS = ConfigNode()
    m.RESNETS.DEPTH = 50
    m.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    m.RESNETS.NUM_GROUPS = 1
    m.RESNETS.WIDTH_PER_GROUP = 64
    m.RESNETS.STEM_OUT_CHANNELS = 64
    m.RESNETS.RES2_OUT_CHANNELS = 256
    m.RESNETS.NORM = "FrozenBN"
    m.RESNETS.STRIDE_IN_1X1 = True

    m.CONVNEXT_SIZE = "tiny"  # convnext backbone size (divergen convnext.py)
    m.VIT_SIZE = "B"  # vitdet backbone size (divergen vit.py:236-486)
    m.SWIN = ConfigNode()
    m.SWIN.SIZE = "T"  # T / S / B / L (divergen swintransformer.py:716)
    m.SWIN.USE_CHECKPOINT = False
    # fused window attention kernel (ops/window_attention.py) in every W-MSA
    m.SWIN.FUSED_ATTN = True
    m.SWIN.OUT_FEATURES = (1, 2, 3)

    m.TIMM = ConfigNode()
    m.TIMM.BASE_NAME = "resnet50_in21k"
    m.TIMM.OUT_LEVELS = (3, 4, 5)
    m.TIMM.NORM = "FrozenBN"
    m.TIMM.FREEZE_AT = 0

    m.VIT = ConfigNode()  # DiverGen/divergen/config.py:195-206
    m.VIT.NAME = "ViT-B"
    m.VIT.OUT_FEATURES = ["s3", "s4", "s5"]
    m.VIT.DROP_PATH_RATE = 0.1
    m.VIT.IMG_SIZE = 1024
    m.VIT.USE_ACT_CHECKPOINT = True
    m.VIT.PRETRAIN_IMG_SIZE = 224
    m.VIT.PRETRAIN_USE_CLS_TOKEN = True

    m.CONVNEXT = ConfigNode()
    m.CONVNEXT.SIZE = "L"
    m.CONVNEXT.OUT_FEATURES = (1, 2, 3)

    m.PROPOSAL_GENERATOR = ConfigNode()
    m.PROPOSAL_GENERATOR.NAME = "CenterNet"
    m.PROPOSAL_GENERATOR.MIN_SIZE = 0

    # CenterNet2 dense head (centernet/config.py)
    cn = m.CENTERNET = ConfigNode()
    cn.NUM_CLASSES = 1203
    cn.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    cn.FPN_STRIDES = [8, 16, 32, 64, 128]
    cn.PRIOR_PROB = 0.01
    cn.INFERENCE_TH = 0.0001
    cn.CENTER_NMS = False
    cn.NMS_TH_TRAIN = 0.9
    cn.NMS_TH_TEST = 0.9
    cn.PRE_NMS_TOPK_TRAIN = 4000
    cn.POST_NMS_TOPK_TRAIN = 2000
    cn.PRE_NMS_TOPK_TEST = 1000
    cn.POST_NMS_TOPK_TEST = 256
    cn.NORM = "GN"
    cn.USE_DEFORMABLE = False
    cn.NUM_CLS_CONVS = 4
    cn.NUM_BOX_CONVS = 4
    cn.NUM_SHARE_CONVS = 0
    cn.LOC_LOSS_TYPE = "giou"
    cn.SIGMOID_CLAMP = 1e-4
    cn.HM_MIN_OVERLAP = 0.8
    cn.MIN_RADIUS = 4
    cn.SOI = [[0, 80], [64, 160], [128, 320], [256, 640], [512, 10000000]]
    # reference DEFAULTS (centernet/config.py:29-31) — the published
    # DiverGen Base-C2 yaml overrides to 0.5/0.5/1.0; baking the yaml
    # values in here made raw-default training losses exactly half the
    # reference's (caught by tests/parity/test_full_graph_train_parity.py)
    cn.POS_WEIGHT = 1.0
    cn.NEG_WEIGHT = 1.0
    cn.REG_WEIGHT = 2.0
    cn.HM_FOCAL_BETA = 4
    cn.HM_FOCAL_ALPHA = 0.25
    cn.LOSS_GAMMA = 2.0
    cn.WITH_AGN_HM = True
    cn.ONLY_PROPOSAL = True
    cn.AS_PROPOSAL = False
    cn.IGNORE_HIGH_FP = 0.85
    cn.MORE_POS = False
    cn.MORE_POS_THRESH = 0.2
    cn.MORE_POS_TOPK = 9
    cn.NOT_NORM_REG = True
    cn.NOT_NMS = False

    r = m.ROI_HEADS = ConfigNode()
    r.NAME = "DeticCascadeROIHeads"
    r.NUM_CLASSES = 1203
    r.IN_FEATURES = ["p3", "p4", "p5"]
    r.IOU_THRESHOLDS = [0.5]  # d2 default; DiverGen yaml sets [0.6]
    r.IOU_LABELS = [0, 1]
    r.BATCH_SIZE_PER_IMAGE = 512
    r.POSITIVE_FRACTION = 0.25
    r.SCORE_THRESH_TEST = 0.02
    r.NMS_THRESH_TEST = 0.5
    r.PROPOSAL_APPEND_GT = True
    r.MASK_WEIGHT = 1.0
    r.ONE_CLASS_PER_PROPOSAL = False
    r.DETECTIONS_PER_IMAGE = 300

    b = m.ROI_BOX_HEAD = ConfigNode()
    b.NAME = "FastRCNNConvFCHead"
    b.NUM_FC = 2
    b.FC_DIM = 1024
    b.NUM_CONV = 0
    b.CONV_DIM = 256
    b.NORM = ""
    b.POOLER_RESOLUTION = 7
    b.POOLER_SAMPLING_RATIO = 0
    b.POOLER_TYPE = "ROIAlignV2"
    b.CLS_AGNOSTIC_BBOX_REG = True
    # geometric-mean fusion of proposal and class scores at inference
    # (detic_roi_heads.py:251; the reference declares this under
    # ROI_BOX_HEAD — yaml merges land here)
    b.MULT_PROPOSAL_SCORE = True
    b.SMOOTH_L1_BETA = 0.0
    b.BBOX_REG_LOSS_TYPE = "smooth_l1"
    b.BBOX_REG_LOSS_WEIGHT = 1.0
    b.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    b.TRAIN_ON_PRED_BOXES = False
    # Detic extensions (divergen/config.py:30-78)
    b.MULT_OBJECT_SCORE = False
    b.USE_ZEROSHOT_CLS = False
    b.ZEROSHOT_WEIGHT_PATH = ""
    b.ZEROSHOT_WEIGHT_DIM = 512
    b.NORM_WEIGHT = True
    b.NORM_TEMP = 50.0
    b.IGNORE_ZERO_CATS = False
    b.USE_BIAS = 0.0
    b.USE_FED_LOSS = True
    b.CAT_FREQ_PATH = "datasets/metadata/lvis_v1_train_cat_info.json"
    b.FED_LOSS_FREQ_WEIGHT = 0.5
    b.FED_LOSS_NUM_CAT = 50
    b.USE_SIGMOID_CE = True
    b.PRIOR_PROB = 0.01
    b.DEL_RARE_CLS = False
    b.ADD_IMAGE_BOX = False
    b.IMAGE_BOX_SIZE = 1.0
    b.IMAGE_LABEL_LOSS = "max_size"
    b.IMAGE_LOSS_WEIGHT = 0.1
    b.WITH_SOFTMAX_PROP = False
    b.CAPTION_WEIGHT = 1.0
    b.NEG_CAP_WEIGHT = 0.125
    b.ADD_FEATURE_TO_PROP = False
    b.SOFTMAX_WEAK_LOSS = False
    b.WS_NUM_PROPS = 128  # proposals kept for image-labeled data

    cascade = m.ROI_BOX_CASCADE_HEAD = ConfigNode()
    cascade.BBOX_REG_WEIGHTS = (
        (10.0, 10.0, 5.0, 5.0),
        (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0),
    )
    # d2 DEFAULT (detectron2 config/defaults.py:332); the DiverGen base
    # yaml overrides to [0.6, 0.7, 0.8]. Baking the yaml values in as
    # defaults made raw-default stage matching diverge from the reference
    # (tests/parity/test_full_graph_train_parity.py). Stage 0's sampling
    # threshold is IOUS[0] (cascade_rcnn.py:99 asserts it equals
    # ROI_HEADS.IOU_THRESHOLDS[0]).
    cascade.IOUS = (0.5, 0.6, 0.7)

    mk = m.ROI_MASK_HEAD = ConfigNode()
    mk.NAME = "MaskRCNNConvUpsampleHead"
    mk.NUM_CONV = 4
    mk.CONV_DIM = 256
    mk.NORM = ""
    mk.POOLER_RESOLUTION = 14
    mk.POOLER_SAMPLING_RATIO = 0
    mk.POOLER_TYPE = "ROIAlignV2"
    mk.CLS_AGNOSTIC_MASK = True
    mk.GT_SIDE = 28  # box-frame gt-mask crop side (static-shape design)
    mk.SEM_SEG_ON = False  # aux semantic target (DatasetMapperWithSemSeg)
    mk.SEM_SEG_STRIDE = 8
    mk.SEM_SEG_WEIGHT = 0.25
    # RefineMask head (divergen refine_mask_head.py:79)
    mk.OUT_CHANNEL = 256
    mk.NUM_FCS = 2
    mk.STAGE_NUM_CLASSES = [80, 80, 80, 80]
    mk.STAGE_SUP_SIZE = [14, 28, 56, 112]

    m.MODEL_EMA = 0.0  # decay; 0 disables (ref divergen/ema.py + config)

    # BSGAL active-learning block (BSGAL/bsgal/config.py:54-79)
    a = m.ACTIVE = ConfigNode()
    a.ENABLED = False
    a.MODE = "paste_or_ori"  # paste_or_zero | paste_or_ori | paste_only
    a.LOSS = ["loss_cls_stage0", "loss_cls_stage1", "loss_cls_stage2"]
    a.GRAD_COMPARE = True
    a.FORWARD_ONCE = True
    # when set, the reference mode string drives threshold/dynamic parsing
    # (ActiveConfig.from_cfg); empty → the declarative THRESHOLD/
    # DYNAMIC_THRESHOLD flags below apply directly
    a.ONCE_MODE = ""
    a.MOMENTUM = 0.1
    a.BANK_UPDATE_PERIOD = 1
    a.BANK_CKPT_PERIOD = 10000
    a.THRESHOLD = -0.05
    a.DYNAMIC_THRESHOLD = False
    a.DYNAMIC_PERCENT = 0.5
    a.QUEUE_SIZE = 1000
    a.PROBE_BATCH = 4
    a.OPTIMIZER = "SGD"
    a.INNER_LR = 0.01
    a.SEPARATE_SYN = False
    a.LOG_PERIOD = 100
    # decision-baseline ablations (ref ACTIVE_COMPARE, custom_rcnn.py:
    # 1097-1169): default | all | random | random_<p> | prob | schedule
    a.COMPARE = "default"
    a.SCHEDULE_ITERS = 90000  # 'schedule' ramp length (ref hardcodes 90000)
    # per-paste-instance loss columns + unique paste ids (ref
    # ACTIVE_ONLY_GT_TRAIN + reset_instance_source, custom_rcnn.py:317-345,
    # detic_fast_rcnn.py:393-429)
    a.ONLY_GT_TRAIN = False
    # per-instance (not per-batch) paste decisions driven by the per-paste
    # loss columns (enabled by the unique ids)
    a.PER_INSTANCE = False
    a.PER_INSTANCE_PERCENT = 0.9  # drop pasted instances above this loss quantile

    # ---------------- INPUT ----------------
    i = c.INPUT = ConfigNode()
    i.FORMAT = "RGB"
    i.MIN_SIZE_TRAIN = (640,)
    i.MAX_SIZE_TRAIN = 1333
    i.MIN_SIZE_TEST = 640
    i.MAX_SIZE_TEST = 1333
    i.MASK_FORMAT = "bitmask"
    i.CUSTOM_AUG = "EfficientDetResizeCrop"
    i.TRAIN_SIZE = 640
    i.TEST_SIZE = 640
    i.SCALE_RANGE = (0.1, 2.0)
    i.RANDOM_FLIP = "horizontal"
    i.TEST_INPUT_TYPE = "default"  # default|square (BSGAL train_net.py:96-99)
    # copy-paste surface (divergen/config.py:79-180)
    i.USE_COPY_PASTE = False
    i.INST_POOL = True
    i.INST_POOL_PATH = ""
    i.INST_POOL_ROOT = ""
    i.INST_POOL_SAMPLE_STRATEGY = "random"  # random|cas_random|cats_random|...
    i.CP_METHOD = "basic"  # basic|alpha|gaussian|possion (custom_cp_method.py:5)
    i.COPY_METHOD = "both"  # both|self_copy|syn_copy|p:<f> (mapper :884-890)
    i.SELF_COPY_MODE = "random"  # random|in_domain|cas|the_cls
    i.SELF_COPY_CLS = []  # class ids for the_cls mode (reference SCP_SELECT_CLS)
    i.RM_BG_PROB = 0.0
    i.USE_INSTABOOST = False
    i.USE_COLOR_JITTER = False
    i.COLOR_JITTER_FREQ = ["r", "c", "f"]
    i.INST_POOL_FREQ = ["r", "c", "f"]
    i.FILTER_VAL = 0.0
    i.RANDOM_SCALE = False  # uniform scale sampling vs area priors (:386-398)
    i.RANDOM_SCALE_MIN = 0.1
    i.RANDOM_SCALE_MAX = 2.0
    i.RANDOM_SCALE_MIN_SIZE = 5  # reject pastes smaller than this (:392)
    i.AREA_PRIOR_PATH = "datasets/metadata/area_mean_std2.json"
    i.PASTE_MAX_INST = 20
    i.BLANK_RATIO = 0.0
    # inpaint-rotate augmentation (ref config.py:175-179; the reference
    # applies it w.p. 2/3 via np.random.randint(0,3), custom_copypaste.py:251)
    i.USE_INP_ROTATE = False
    i.INP_ROTATE_PROB = 0.667
    i.INP_ROTATE_ANG = 30
    i.VIS_RESULT = False
    i.LOG_SCP_PARAM = False
    i.RC_ONLY = False
    i.F_ONLY = False
    i.RFS_VERSION = 0
    i.USE_RFS = False
    # BSGAL extras (bsgal/config.py:177-197)
    i.ACTIVE_SELECT = False
    i.SEPARATE_SYN = False
    i.SEPERATE_SUP = False
    i.TRANSITION_MATRIX_PATH = ""

    # ---------------- DATASETS ----------------
    d = c.DATASETS = ConfigNode()
    d.TRAIN = ("lvis_v1_train",)
    d.TEST = ("lvis_v1_val",)
    d.LVIS_PATH = "datasets/lvis"
    d.IMAGE_ROOT = "datasets/coco"
    d.METADATA_PATH = "datasets/metadata"

    # ---------------- DATALOADER ----------------
    dl = c.DATALOADER = ConfigNode()
    dl.NUM_WORKERS = 4
    dl.SAMPLER_TRAIN = "TrainingSampler"
    dl.REPEAT_THRESHOLD = 0.001
    dl.FILTER_EMPTY_ANNOTATIONS = False
    dl.ASPECT_RATIO_GROUPING = True
    dl.DATASET_RATIO = [1.0]
    dl.USE_DIFF_BS_SIZE = False
    dl.DATASET_BS = [8]
    dl.USE_RFS = [False]
    dl.MULTI_DATASET_GROUPING = False
    dl.DATASET_ANN = ["box"]
    dl.USE_TAR_DATASET = False  # ImageNet-21k in per-class tars (ref config.py:90-92)
    dl.TARFILE_PATH = "datasets/imagenet/metadata-22k/tar_files.npy"
    dl.TAR_INDEX_DIR = "datasets/imagenet/metadata-22k/tarindex_npy"
    dl.PREFETCH_FACTOR = 2
    dl.MAX_INSTANCES = 100  # static padded capacity per image
    dl.MAX_PASTES = 8  # static paste slots per image (device compositor)
    dl.PATCH_SIZE = 128  # canonical RGBA patch side fed to the compositor
    dl.NUM_WORKERS = 4
    dl.PREFETCH_TO_DEVICE = 2

    # ---------------- SOLVER ----------------
    s = c.SOLVER = ConfigNode()
    s.IMS_PER_BATCH = 16
    s.BASE_LR = 0.0001
    s.MAX_ITER = 90000
    s.OPTIMIZER = "ADAMW"
    s.MOMENTUM = 0.9
    s.WEIGHT_DECAY = 0.0001
    s.WEIGHT_DECAY_NORM = 0.0
    s.LR_SCHEDULER_NAME = "WarmupCosineLR"
    s.STEPS = (60000, 80000)
    s.GAMMA = 0.1
    s.WARMUP_FACTOR = 0.001
    s.WARMUP_ITERS = 10000
    s.WARMUP_METHOD = "linear"
    s.CLIP_GRADIENTS = ConfigNode()
    s.CLIP_GRADIENTS.ENABLED = False
    s.CLIP_GRADIENTS.CLIP_TYPE = "full_model"
    s.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    s.CLIP_GRADIENTS.NORM_TYPE = 2.0
    s.RESET_ITER = False
    s.TRAIN_ITER = -1
    s.USE_CUSTOM_SOLVER = True
    s.BACKBONE_MULTIPLIER = 1.0
    s.CUSTOM_MULTIPLIER = 1.0
    s.CUSTOM_MULTIPLIER_NAME = []
    s.CHECKPOINT_PERIOD = 10000

    # ---------------- TEST ----------------
    t = c.TEST = ConfigNode()
    t.EVAL_PERIOD = 0
    t.DETECTIONS_PER_IMAGE = 300
    # static pre-NMS (proposal, class) candidate cap; 0 = 4x the above
    # (the torch reference NMS-es every candidate above threshold — raise
    # for exact tail parity at extra NMS cost)
    t.NMS_CANDIDATES = 0
    t.AUG = ConfigNode()
    t.AUG.ENABLED = False

    # ---------------- PARALLEL (the JAX package's mesh flags) ---
    p = c.PARALLEL = ConfigNode()
    p.MESH_AXES = ("data", "model")
    p.DATA_PARALLEL = -1  # -1: all devices on the data axis
    p.MODEL_PARALLEL = 1
    p.REMAT = False  # rematerialize the backbone

    _declare_reference_aliases(c)
    import builtins  # noqa: F401  (object.__setattr__ below bypasses freeze)

    object.__setattr__(c, "_post_merge", normalize_reference_aliases)
    return c


# --------------------------------------------------------------------------
# Reference flat-key aliases: the actual DiverGen/BSGAL YAMLs use FLAT names
# (MODEL.ACTIVE_GRAD_COMPARE, SOLVER.MODEL_EMA, INPUT.USE_COPY_METHOD, …)
# where this tree nests them. Declaring the aliases lets those YAMLs merge;
# ``normalize_reference_aliases`` (run after every merge_from_file) copies
# any alias that was CHANGED from its reference default onto the canonical
# key, so the settings actually take effect.
# --------------------------------------------------------------------------

# (alias path, reference default, canonical path or transform)
_REF_ALIASES = [
    ("SOLVER.MODEL_EMA", 0.0, "MODEL.MODEL_EMA"),
    ("MODEL.ACTIVE_MODE", "paste_or_zero", "MODEL.ACTIVE.MODE"),
    ("MODEL.ACTIVE_COMPARE", "default", "MODEL.ACTIVE.COMPARE"),
    ("MODEL.ACTIVE_GRAD_COMPARE", False, "MODEL.ACTIVE.GRAD_COMPARE"),
    ("MODEL.ACTIVE_FORWARD_ONCE", False, "MODEL.ACTIVE.FORWARD_ONCE"),
    ("MODEL.ACTIVE_ONCE_MODE", "only_gt", "MODEL.ACTIVE.ONCE_MODE"),
    ("MODEL.ACTIVE_TEST_BATCHSIZE", 4, "MODEL.ACTIVE.PROBE_BATCH"),
    ("MODEL.ACTIVE_LR", 0.0001, "MODEL.ACTIVE.INNER_LR"),
    ("MODEL.ACTIVE_OPTIMIZER_MODE", "sgd", "MODEL.ACTIVE.OPTIMIZER"),
    ("MODEL.ACTIVE_ONLY_GT_TRAIN", False, "MODEL.ACTIVE.ONLY_GT_TRAIN"),
    ("INPUT.USE_COPY_METHOD", "both", "INPUT.COPY_METHOD"),
    ("INPUT.INST_POOL_SAMPLE_TYPE", "random", "INPUT.INST_POOL_SAMPLE_STRATEGY"),
    ("INPUT.SCP_TYPE", "", "INPUT.SELF_COPY_MODE"),
    ("INPUT.SCP_SELECT_CATS_LIST", [], "INPUT.SELF_COPY_CLS"),
    ("INPUT.SCP_RFS", False, "INPUT.USE_RFS"),
    ("INPUT.INST_POOL_MAX_SAMPLES", 20, "INPUT.PASTE_MAX_INST"),
    ("INPUT.INST_POOL_FILTER_VAL", False, "INPUT.FILTER_VAL"),
    ("INPUT.MEAN_STD2_PATH", "datasets/metadata/area_mean_std2.json",
     "INPUT.AREA_PRIOR_PATH"),
    ("INPUT.COLOR_AUG", False, "INPUT.USE_COLOR_JITTER"),
    ("INPUT.COLOR_JITTER_FREQ_FILTER", ["r"], "INPUT.COLOR_JITTER_FREQ"),
    ("INPUT.ONLY_RC", False, "INPUT.RC_ONLY"),
]

# merge-compat only: reference research switches without a canonical
# counterpart here (torch-side toggles, save/debug paths); enumerated in
# tests/test_config.py::DECLARED_ONLY with reasons
_REF_DECLARED_ONLY = [
    ("MODEL.ACTIVE_LOSS", "cls"),
    ("MODEL.ACTIVE_LOSS_UPDATE", "all"),
    ("MODEL.ACTIVE_SEED", 0),
    ("MODEL.ACTIVE_TEST", "select"),
    ("MODEL.ACTIVE_TEST_INS", "one"),
    ("MODEL.ACTIVE_OPTIMIZER", True),
    ("MODEL.ACTIVE_PRED", False),
    ("MODEL.ACTIVE_PRED_CHOOSE", ""),
    ("MODEL.ACTIVE_PRED_SUP", "all"),
    ("MODEL.ACTIVE_ONLY_GT_TEST", False),
    ("MODEL.ACTIVE_GRAD_NORM", True),
    ("MODEL.ACTIVE_GRAD_SAVE", False),
    ("MODEL.ACTIVE_EVAL", False),
    ("MODEL.ACTIVE_DYNAMIC_THRES", 0.0),
    ("MODEL.ONLY_PASTE_SUP", False),
    ("MODEL.ENABLE_STATIC_GRAPH", False),  # DDP knob; everything is static here
    ("MODEL.FREEZE_MODEL", False),
    ("MODEL.NOT_FREEZE_LIST", []),
    ("MODEL.ROI_HEADS.SEG_IN_FEATURE", "p3"),
    ("MODEL.ROI_BOX_HEAD.USE_EQL_LOSS", False),
    ("MODEL.ROI_BOX_HEAD.EQL_FREQ_CAT", 200),
    ("MODEL.REFINE_MASK.SEMANTIC_OUT_STRIDE", 8),  # ref bsgal/config.py:44
    ("MODEL.CENTERNET.FREEZE_BACKBONE", False),
    ("MODEL.CENTERNET.NO_REDUCE", False),
    ("MODEL.VIT.USE_CHECKPOINT", False),
    ("INPUT.INST_POOL_FORMAT", "RGBA"),
    ("INPUT.INST_POOL_ORDER_SEED", 0),
    ("INPUT.INST_POOL_FIX_ORDER_SEED", False),
    ("INPUT.INST_POOL_AREA_CERTAINTY", False),
    ("INPUT.INST_POOL_AREA_STD_THRES", 0.0),
    ("INPUT.RANDOM_ROTATE", False),
    ("INPUT.ROTATE_SRC", False),
    ("INPUT.ACTIVE_SELECT_TYPE", "train"),
    ("INPUT.TRANSITION_MATRIX_PATH", ""),
    ("INPUT.COLOR_JITTER_APPLY_TYPE", "syn"),
    ("INPUT.COLOR_JITTER_USE_TORCHVISION", False),
    # consumed by CopyPasteMapper's functional InstaBoost port; reference
    # defaults (divergen/config.py:171-173)
    ("INPUT.INSTABOOST_APPLY_TYPE", "both"),
    ("INPUT.INSTABOOST_FREQ", ["r", "c", "f"]),
    ("INPUT.INP_ANNO", ""),
    ("INPUT.INP_ROOT", ""),
    ("INPUT.INP_ROTATE_LIMIT", False),
    ("INPUT.LIMIT_SRC_LSJ", False),
    ("INPUT.SCP_NUM_SRC", 1),
    ("INPUT.SCP_SRC_OBJ_SELECT", True),
    ("INPUT.SELECT_CATS_LIST", []),
    ("INPUT.USE_SCP", True),
    ("INPUT.USE_IMGNET", False),  # set by the flagship YAML, read NOWHERE
    #  in the reference either
    ("DATALOADER.DATASET_INPUT_SCALE", []),
    ("DATALOADER.DATASET_INPUT_SIZE", []),
    ("DATALOADER.DATASET_MAX_SIZES", []),
    ("DATALOADER.DATASET_MIN_SIZES", []),
    ("DATASETS.SEMANTIC_ROOT", ""),
    ("DATASETS.VAL", ()),
    ("DATASETS.SAVE_LOGITS", False),
    ("SAVE_DEBUG_PATH", ""),
    ("EVAL_PRED_AR", False),
    ("TEST.ANALYSE", False),
    ("TEST.GEN_DATASET", False),
    ("USE_LARGEST_PART", True),
]


def _get_path(cfg, path):
    node = cfg
    for part in path.split("."):
        node = node[part]
    return node


def _set_path(cfg, path, value):
    parts = path.split(".")
    node = cfg
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value


def _declare_reference_aliases(c: ConfigNode) -> None:
    # nested blocks referenced by the declared-only keys
    c.MODEL.REFINE_MASK = ConfigNode()
    c.MODEL.DETR = ConfigNode()  # vendored Deformable-DETR config surface;
    # no published DiverGen/BSGAL recipe instantiates the DETR meta-arch
    for k, v in dict(
        CLS_WEIGHT=2.0, DEC_LAYERS=6, DEEP_SUPERVISION=True,
        DIM_FEEDFORWARD=2048, DROPOUT=0.1, ENC_LAYERS=6, FOCAL_ALPHA=0.25,
        FROZEN_WEIGHTS="", GIOU_WEIGHT=2.0, HIDDEN_DIM=256, L1_WEIGHT=5.0,
        NHEADS=8, NO_OBJECT_WEIGHT=0.1, NUM_CLASSES=80, NUM_FEATURE_LEVELS=4,
        NUM_OBJECT_QUERIES=300, PRE_NORM=False, TWO_STAGE=False,
        USE_FED_LOSS=False, WEAK_WEIGHT=0.1, WITH_BOX_REFINE=False,
    ).items():
        c.MODEL.DETR[k] = v
    # CenterNet2 real-time backbones (centernet/config.py): BIFPN drives the
    # BiFPN neck in build_model; DLA selects the DLA-34 bottom-up
    bf = c.MODEL.BIFPN = ConfigNode()
    bf.NUM_LEVELS = 5
    bf.NUM_BIFPN = 4
    bf.NORM = "GN"
    bf.OUT_CHANNELS = 160
    bf.SEPARABLE_CONV = False
    dla = c.MODEL.DLA = ConfigNode()
    dla.NUM_LAYERS = 34
    dla.NORM = "BN"
    dla.USE_DLA_UP = True
    dla.DLAUP_IN_FEATURES = ["dla3", "dla4", "dla5"]
    dla.DLAUP_NODE = "conv"
    dla.MS_OUTPUT = False
    dla.OUT_FEATURES = ["dla2"]
    for path, default, _canonical in _REF_ALIASES:
        _set_path(c, path, default)
    for path, default in _REF_DECLARED_ONLY:
        _set_path(c, path, default)
    # grad-bank update spec: "AVERAGE" | "MOMENTUM<x>" (bsgal config.py:72)
    c.MODEL.ACTIVE_GRAD_UPDATE = "AVERAGE"


def normalize_reference_aliases(cfg: ConfigNode) -> None:
    """Copy reference-named settings onto the canonical keys (post-merge)."""
    for path, default, canonical in _REF_ALIASES:
        try:
            val = _get_path(cfg, path)
        except KeyError:
            continue
        if val != default:
            _set_path(cfg, canonical, val)
    try:
        gu = cfg.MODEL.ACTIVE_GRAD_UPDATE
        if isinstance(gu, str) and gu.upper().startswith("MOMENTUM"):
            cfg.MODEL.ACTIVE.MOMENTUM = float(gu[len("MOMENTUM"):])
    except KeyError:
        pass
    try:
        # the reference enables active selection from the INPUT side
        if cfg.INPUT.ACTIVE_SELECT:
            cfg.MODEL.ACTIVE.ENABLED = True
    except KeyError:
        pass
