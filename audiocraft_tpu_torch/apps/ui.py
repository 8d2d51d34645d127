"""Gradio UI (counterpart of ``audiocraft_tpu/apps/ui.py``): the interactive
surface of the fork's app.py (:676-909).

Gradio is not a dependency of this repository, so this module gates on
import and keeps the layer thin: all generation logic lives in the tested
``predict`` function below (the counterpart of app.py:244-555), which the UI
merely wires to widgets.  A model given by name loads on ``device``
(default: the CUDA card, raising without one).  Run with:

    python -m audiocraft_tpu_torch.apps.ui [--port 7860] [--device cuda]
"""

from __future__ import annotations

import argparse
import tempfile
import typing as tp
from pathlib import Path


def predict(model, text: str, melody: tp.Optional[tuple] = None,
            duration: float = 10.0, overlap: int = 2,
            segment_duration: int = 30, seed: int = -1, top_k: int = 250,
            top_p: float = 0.0, temperature: float = 1.0,
            cfg_coef: float = 3.0,
            history: tp.Optional[tp.Any] = None,
            cache_dir: tp.Optional[str] = None,
            device: tp.Union[str, 'torch.device', None] = None,
            # video/title surface of the reference predict (app.py:244-330:
            # background, title, settings_font*, include_title,
            # include_settings, video_orientation)
            return_video: bool = False,
            title: str = "",
            background: tp.Optional[str] = None,
            include_title: bool = True,
            include_settings: bool = True,
            settings_font: tp.Optional[str] = None,
            settings_font_color: str = "#ffffff",
            settings_font_size: int = 28,
            video_orientation: str = "Landscape",
            audio_format: str = "wav"):
    """Headless predict (app.py:244-555 without the UI plumbing):
    text (+ optional melody) -> wav file path.  Long durations route through
    the segment-stitch extension; results optionally land in a
    GenerationHistory.

    `model` is a MusicGen facade or a model *name* resolved through the
    cached loader on ``device`` (None: the CUDA card; the reference UI's
    model dropdown, app.py:300-315).  The seed seeds a ``torch.Generator``.

    Returns ``(audio_path, seed)``; with ``return_video=True`` returns
    ``(video_path, audio_path, seed)`` — the reference predict's triple
    (app.py:553-555), the MP4 carrying the title/settings card and embedded
    metadata through io/titlecard + io/video.
    """
    import numpy as np
    import torch

    from ..utils.misc import enable_compilation_cache

    if isinstance(model, str):
        from ..builders import resolve_device
        from ..ckpt.loaders import load_model
        device = resolve_device(device)
        enable_compilation_cache(device)
        model = load_model(model, cache_dir, device)
    else:
        enable_compilation_cache(model.device)
    from ..gen.extend import generate_music_segments, stitch_segments
    from ..io.wav import audio_write

    if seed is None or seed < 0:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    generator = torch.Generator().manual_seed(seed)

    model.set_generation_params(
        duration=min(duration, model.max_duration), top_k=top_k, top_p=top_p,
        temperature=temperature, cfg_coef=cfg_coef)

    if melody is not None and duration > segment_duration:
        sr_m, data = melody
        segments, _ = generate_music_segments(
            text, (sr_m, np.asarray(data, np.float32)), seed, model,
            duration=int(duration), overlap=overlap,
            segment_duration=segment_duration)
        wav = stitch_segments(segments, model.sample_rate, overlap)
    elif melody is not None:
        sr_m, data = melody
        arr = np.asarray(data, np.float32)
        if arr.ndim == 1:
            arr = arr[None]
        elif arr.shape[0] > arr.shape[1]:
            arr = arr.T  # gradio numpy audio is [T, C]
        wav = model.generate_with_chroma([text], [arr], sr_m, generator=generator)
    else:
        model.duration = duration
        wav = model.generate([text], generator=generator)
    wav = wav[0].float().cpu().numpy()

    out_dir = Path(tempfile.mkdtemp(prefix="audiocraft_tpu_torch_"))
    path = audio_write(out_dir / "generation", wav,
                       model.sample_rate, format=audio_format,
                       strategy="loudness")
    metadata = {"seed": seed, "duration": duration, "text": text,
                "prompt": text, "model": getattr(model, 'name', ''),
                "topk": top_k, "topp": top_p, "temperature": temperature,
                "cfg_coef": cfg_coef, "title": title}
    video_path = None
    if return_video:
        from ..io.titlecard import settings_text
        from ..io.video import make_waveform_video
        # Portrait swaps the card dimensions (reference app.py:464-466)
        width, height = ((512, 768) if video_orientation == "Portrait"
                         else (768, 512))
        video_path = make_waveform_video(
            out_dir / "generation.mp4", wav,
            model.sample_rate, metadata=metadata,
            title=title if include_title else "",
            settings=settings_text(metadata) if include_settings else "",
            background=background, width=width, height=height,
            font=settings_font, font_color=settings_font_color,
            font_size=settings_font_size)
    if history is not None:
        history.save(path, label=title or text, metadata=metadata)
    if return_video:
        return video_path, path, seed
    return path, seed


def build_ui(model, cache_dir: tp.Optional[str] = None,
             device: tp.Union[str, 'torch.device', None] = None):
    """Construct the Gradio Blocks UI (requires gradio).

    `model` may be a facade or a name; a model dropdown lists every locally
    imported checkpoint (cached switching, reference app.py:300-315).
    """
    try:
        import gradio as gr
    except ImportError as exc:  # pragma: no cover - env without gradio
        raise RuntimeError(
            "gradio is not installed; use apps.serve (REST) or apps.generate "
            "(CLI) instead") from exc

    from ..ckpt.loaders import list_local_models, load_model
    from .history import GenerationHistory
    history = GenerationHistory(Path.home() / ".audiocraft_tpu_torch" / "history")
    initial_name = model if isinstance(model, str) else model.name

    def _run(model_name, text, melody, duration, overlap, seed, top_k, top_p,
             temperature, cfg_coef, progress=gr.Progress()):
        mdl = (load_model(model_name, cache_dir, device)
               if isinstance(model_name, str) else model)
        mdl.set_custom_progress_callback(
            lambda frac, msg: progress(frac, desc=msg))
        path, used_seed = predict(
            mdl, text, melody, duration=duration, overlap=int(overlap),
            seed=int(seed), top_k=int(top_k), top_p=float(top_p),
            temperature=float(temperature), cfg_coef=float(cfg_coef),
            history=history)
        return str(path), used_seed

    with gr.Blocks(title="audiocraft_tpu_torch") as demo:
        gr.Markdown("# audiocraft_tpu_torch — MusicGen on CUDA")
        with gr.Row():
            with gr.Column():
                model_name = gr.Dropdown(
                    choices=list_local_models(cache_dir),
                    value=initial_name, label="Model")
                text = gr.Textbox(label="Description")
                melody = gr.Audio(label="Melody (optional)", type="numpy")
                duration = gr.Slider(1, 720, value=10, label="Duration (s)")
                overlap = gr.Slider(0, 15, value=2, step=1, label="Overlap (s)")
                seed = gr.Number(value=-1, label="Seed (-1 = random)")
                with gr.Accordion("Sampling", open=False):
                    top_k = gr.Number(value=250, label="top_k")
                    top_p = gr.Number(value=0.0, label="top_p")
                    temperature = gr.Number(value=1.0, label="temperature")
                    cfg_coef = gr.Number(value=3.0, label="cfg_coef")
                submit = gr.Button("Generate", variant="primary")
            with gr.Column():
                audio_out = gr.Audio(label="Generated audio")
                seed_out = gr.Number(label="Seed used")
        submit.click(_run,
                     inputs=[model_name, text, melody, duration, overlap,
                             seed, top_k, top_p, temperature, cfg_coef],
                     outputs=[audio_out, seed_out])
    return demo


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--share", action="store_true")
    parser.add_argument("--model", default="debug")
    parser.add_argument("--cache-dir", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card); 'cpu' runs the plain "
                             "versions")
    args = parser.parse_args(argv)

    demo = build_ui(args.model, cache_dir=args.cache_dir, device=args.device)
    demo.launch(server_port=args.port, share=args.share)


if __name__ == "__main__":
    main()
