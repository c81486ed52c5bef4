"""The three reference training stages as TrainConfig presets (copy of
tdc_video_tpu/train/stages.py, which is pure Python).

Mirrors scripts/stage{1,2,3}/*.sh flag-for-flag; use
`python -m tdc_video_tpu_torch.train.run --stage 3 ...` or import the preset
and override fields.  The presets report to TensorBoard
(torch.utils.tensorboard; `--report_to jsonl` where it does not import).
"""

from __future__ import annotations

from .trainer import TrainConfig


def stage1_image_align(output_dir: str = "./checkpoints/stage1") -> TrainConfig:
    """Image alignment (scripts/stage1/train_image_qwen.sh): lr 4e-5,
    576 image tokens, FSDP full-shard, bf16, bs 8 x accum 1."""
    return TrainConfig(
        output_dir=output_dir,
        learning_rate=4e-5,
        warmup_ratio=0.03,
        num_train_epochs=1,
        per_device_train_batch_size=8,
        gradient_accumulation_steps=1,
        save_steps=1000,
        save_total_limit=1,
        model_max_length=8192,
        max_train_frames=1,
        unfreeze_mm_compressor=False,
        loss_chunk=512,  # B=8 x 8k x 128k-vocab f32 logits would be ~33 GB
        report_to="tensorboard",
    )


def stage2_video_sft(output_dir: str = "./checkpoints/stage2") -> TrainConfig:
    """Video SFT (scripts/stage2/train_video_qwen.sh): lr 5e-6, 144 image
    tokens, 1 fps, 16 ctx tokens, bs 1 x accum 2."""
    return TrainConfig(
        output_dir=output_dir,
        learning_rate=5e-6,
        warmup_ratio=0.03,
        num_train_epochs=1,
        per_device_train_batch_size=1,
        gradient_accumulation_steps=2,
        save_steps=1000,
        save_total_limit=1,
        model_max_length=8192,
        max_train_frames=224,
        group_by_modality_length=True,
        loss_chunk=512,  # chunked CE: 8k x 128k-vocab f32 logits never live
        report_to="tensorboard",
    )


def stage3_audio_lora(output_dir: str = "./checkpoints/stage3") -> TrainConfig:
    """Audio+video LoRA (scripts/stage3/train_video_audio_qwen_lora.sh):
    lora r=128 alpha=256, lr 5e-6, the LM frozen under the adapters.
    `quantize_frozen="int8"` (`--quantize_frozen int8`) stores the frozen
    base as weight-only int8 (QLoRA)."""
    return TrainConfig(
        output_dir=output_dir,
        learning_rate=5e-6,
        warmup_ratio=0.03,
        num_train_epochs=1,
        per_device_train_batch_size=1,
        gradient_accumulation_steps=2,
        save_steps=1000,
        save_total_limit=1,
        model_max_length=8192,
        max_train_frames=224,
        loss_chunk=512,  # chunked CE (models/lm.lm_loss)
        lora_enable=True,
        lora_r=128,
        lora_alpha=256,
        report_to="tensorboard",
    )


STAGES = {1: stage1_image_align, 2: stage2_video_sft, 3: stage3_audio_lora}
