"""Config key constants — the port's copy of the keys and defaults of
``deepspeed_tpu/runtime/constants.py`` that the training slice reads, so
JSON configs carry over unchanged."""

#############################################
# Batch size
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
TYPE = "type"
SCHEDULER = "scheduler"

#: the optimizers this port runs on the device (ops/optimizers.py)
PORTED_OPTIMIZERS = ["adam", "adamw", "fusedadam", "lamb", "fusedlamb",
                     "sgd", "adagrad", "lion"]
#: and with zero_optimization.offload_optimizer (ops/cpu_adam.py)
OFFLOAD_OPTIMIZERS = ["adam", "adamw", "fusedadam", "adagrad"]
ONEBIT_OPTIMIZERS = ["onebitadam", "onebitlamb", "zerooneadam"]

#############################################
# Precision
#############################################
SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False

FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False

BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"  # keeping for backwards compatibility
BFLOAT16_ENABLED = "enabled"
BFLOAT16_ENABLED_DEFAULT = False

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

#############################################
# Steps / logging
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

#############################################
# Dataloader
#############################################
DATALOADER_DROP_LAST = "dataloader_drop_last"
DATALOADER_DROP_LAST_DEFAULT = False

ACTIVATION_CHECKPOINTING = "activation_checkpointing"
ZERO_OPTIMIZATION = "zero_optimization"

#############################################
# Features refused until their slice lands
#############################################
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"
DATA_EFFICIENCY = "data_efficiency"
COMPRESSION_TRAINING = "compression_training"
FLOPS_PROFILER = "flops_profiler"
MONITORS = ("tensorboard", "wandb", "csv_monitor")
PIPELINE = "pipeline"
ELASTICITY = "elasticity"
MESH = "mesh"

#############################################
# Misc
#############################################
SEED = "seed"
SEED_DEFAULT = None
