"""Gradio web UI for inference (reference src/f5_tts/infer/infer_gradio.py).

Full reference tab set — Basic TTS, Multi-Speech (dynamic speech types with
per-segment seed/speed markers), Voice Chat (local LLM + mic transcription),
Credits — plus the F5/E2/Custom model selector with last-used persistence.
All decision logic lives in ``gradio_logic.py`` (unit-tested without gradio);
this module is the UI shell.

gradio is an optional dependency — importing this module without it raises a
clear error; everything else in the package works without gradio.

JAX counterpart: ``f5_tts_tpu/infer/gradio_app.py`` (the imports changed to
the port's; ``build_app`` and ``--device`` take the engine's device, the
card unless ``cpu`` is asked for).  It imports ``gradio`` inside
``build_app`` and raises without it, as JAX's does.
"""

from __future__ import annotations

import json
import os

import numpy as np

from f5_tts_tpu_torch.infer import gradio_logic as L

MAX_SPEECH_TYPES = 100  # reference infer_gradio.py:429

DEFAULT_TTS_MODEL = "F5-TTS_v1"
MODEL_ALIASES = {"F5-TTS_v1": "F5TTS_v1_Base", "F5-TTS": "F5TTS_Base", "E2-TTS": "E2TTS_Base"}


def build_app(tts=None, cache_path: str | None = None, device: str | None = None):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed; `pip install gradio` to use the web UI"
        ) from e

    from f5_tts_tpu_torch.infer.api import F5TTS

    state = {"tts": tts, "choice": DEFAULT_TTS_MODEL, "cache": L.InferCache()}

    def ensure_model():
        """Instantiate/reuse the engine for the current model choice."""
        choice = state["choice"]
        if isinstance(choice, tuple):  # ("Custom", ckpt, vocab, cfg_json)
            _, ckpt, vocab, cfg_json = choice
            key = choice
            kwargs = dict(ckpt_file=ckpt, vocab_file=vocab or "")
            try:
                kwargs["model_cfg"] = json.loads(cfg_json) if cfg_json else None
            except json.JSONDecodeError:
                kwargs["model_cfg"] = None
            model_name = "F5TTS_v1_Base"
        else:
            model_name = MODEL_ALIASES.get(choice, choice)
            key = (model_name, os.environ.get("F5_TTS_TPU_CKPT", ""))
            kwargs = dict(ckpt_file=key[1])
        if state["tts"] is None or getattr(state["tts"], "_ui_key", None) != key:
            state["tts"] = F5TTS(model=model_name, device=device,
                                 **{k: v for k, v in kwargs.items() if v})
            state["tts"]._ui_key = key
        return state["tts"]

    def infer(ref_audio, ref_text, gen_text, remove_silence, seed,
              cross_fade_duration=0.15, nfe_step=32, speed=1.0):
        """Cached synthesis; returns ((sr, wav_int16), spec, ref_text, seed)."""
        if not ref_audio:
            gr.Warning("Please provide reference audio.")
            return None, None, ref_text, seed
        if not gen_text.strip():
            gr.Warning("Please enter text to generate or upload a text file.")
            return None, None, ref_text, seed
        seed = L.normalize_seed(int(seed))
        key = (ref_audio, ref_text, gen_text, str(state["choice"]), remove_silence,
               seed, cross_fade_duration, int(nfe_step), speed)

        def compute():
            tts_obj = ensure_model()
            wav, sr, spec = tts_obj.infer(
                ref_audio, ref_text, gen_text,
                cross_fade_duration=cross_fade_duration, nfe_step=int(nfe_step),
                speed=speed, remove_silence=remove_silence, seed=seed,
            )
            used_ref_text = getattr(tts_obj, "last_ref_text", ref_text) or ref_text
            return (sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16)), spec, used_ref_text

        audio, spec, ref_text_out = state["cache"].get_or_compute(key, compute)
        return audio, spec, ref_text_out, seed

    def spec_to_plot(spec):
        if spec is None:
            return None
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        import tempfile

        fig, ax = plt.subplots(figsize=(12, 3))
        ax.imshow(np.asarray(spec).T, origin="lower", aspect="auto", interpolation="none")
        ax.set_xlabel("frames")
        path = tempfile.NamedTemporaryFile(suffix=".png", delete=False).name
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path

    # ------------------------------------------------------------------ UI --
    with gr.Blocks(title="F5-TTS (PyTorch)") as app:
        gr.Markdown(
            "# F5-TTS (PyTorch build)\n"
            "Zero-shot voice cloning on a CUDA card. Reference text is auto-transcribed"
            " with a local Whisper snapshot when left empty; keep reference"
            " clips short (<12 s)."
        )

        # model selector (reference infer_gradio.py:1012-1089)
        with gr.Row():
            choose_tts_model = gr.Radio(
                choices=[DEFAULT_TTS_MODEL, "F5-TTS", "E2-TTS", "Custom"],
                label="Choose TTS Model", value=DEFAULT_TTS_MODEL)
            last = L.load_last_used_custom(cache_path)
            custom_ckpt_path = gr.Dropdown(
                choices=[last[0]] if last[0] else [], value=last[0], allow_custom_value=True,
                label="Model: local path (.safetensors/.pt/.npz)", visible=False)
            custom_vocab_path = gr.Dropdown(
                choices=[last[1]] if last[1] else [], value=last[1], allow_custom_value=True,
                label="Vocab: local path", visible=False)
            custom_model_cfg = gr.Dropdown(
                choices=list(L.CUSTOM_MODEL_CFG_CHOICES), value=last[2],
                allow_custom_value=True, label="Config: in a dictionary form", visible=False)

        def switch_tts_model(new_choice):
            if new_choice == "Custom":
                ckpt, vocab, cfg = L.load_last_used_custom(cache_path)
                state["choice"] = ("Custom", ckpt, vocab, cfg)
                return (gr.update(visible=True, value=ckpt),
                        gr.update(visible=True, value=vocab),
                        gr.update(visible=True, value=cfg))
            state["choice"] = new_choice
            return (gr.update(visible=False),) * 3

        def set_custom_model(ckpt, vocab, cfg):
            state["choice"] = ("Custom", ckpt, vocab, cfg)
            L.save_last_used_custom(ckpt, vocab, cfg, cache_path)

        choose_tts_model.change(
            switch_tts_model, inputs=[choose_tts_model],
            outputs=[custom_ckpt_path, custom_vocab_path, custom_model_cfg],
            show_progress="hidden")
        for comp in (custom_ckpt_path, custom_vocab_path, custom_model_cfg):
            comp.change(set_custom_model,
                        inputs=[custom_ckpt_path, custom_vocab_path, custom_model_cfg],
                        show_progress="hidden")

        # ------------------------------------------------------- Basic TTS --
        with gr.Tab("Basic-TTS"):
            ref_audio = gr.Audio(label="Reference audio", type="filepath")
            with gr.Row():
                ref_text = gr.Textbox(
                    label="Reference text (leave empty to auto-transcribe)", lines=2, scale=4)
                ref_text_file = gr.File(label="Load reference text from .txt", file_types=[".txt"], scale=1)
            with gr.Row():
                gen_text = gr.Textbox(label="Text to generate", lines=6, scale=4)
                gen_text_file = gr.File(label="Load text to generate from .txt", file_types=[".txt"], scale=1)
            with gr.Accordion("Advanced settings", open=False):
                remove_silence = gr.Checkbox(
                    label="Remove silences",
                    info="Helps for long single-sentence generations.", value=False)
                with gr.Row():
                    randomize_seed = gr.Checkbox(label="Randomize seed", value=True,
                                                 info="Uncheck to reproduce a result.")
                    seed_input = gr.Number(label="Seed", value=0, precision=0)
                cross_fade = gr.Slider(0.0, 1.0, value=0.15, step=0.01, label="Cross-fade duration (s)")
                nfe = gr.Slider(4, 64, value=32, step=2, label="NFE steps")
                speed = gr.Slider(0.3, 2.0, value=1.0, step=0.1, label="Speed")
            out_audio = gr.Audio(label="Synthesized audio")
            out_spec = gr.Image(label="Spectrogram")

            def basic_tts(ref_audio_v, ref_text_v, gen_text_v, remove_silence_v,
                          randomize_v, seed_v, cross_fade_v, nfe_v, speed_v):
                seed_v = L.normalize_seed(int(seed_v or 0), randomize=bool(randomize_v))
                audio, spec, ref_text_out, used_seed = infer(
                    ref_audio_v, ref_text_v, gen_text_v, remove_silence_v, seed_v,
                    cross_fade_duration=cross_fade_v, nfe_step=nfe_v, speed=speed_v)
                return audio, spec_to_plot(spec), ref_text_out, used_seed

            for src, dst in ((ref_text_file, ref_text), (gen_text_file, gen_text)):
                src.upload(lambda f: gr.update(value=L.load_text_from_file(f)),
                           inputs=[src], outputs=[dst])
            gr.Button("Synthesize", variant="primary").click(
                basic_tts,
                inputs=[ref_audio, ref_text, gen_text, remove_silence,
                        randomize_seed, seed_input, cross_fade, nfe, speed],
                outputs=[out_audio, out_spec, ref_text, seed_input])

        # ----------------------------------------------------- Multi-Speech --
        with gr.Tab("Multi-Speech"):
            gr.Markdown(
                "Generate multiple speech types / voices in one script. Mark"
                " segments with `{Regular}`, `{Angry}`, ... or"
                ' `{"name": "Speaker1_Happy", "seed": -1, "speed": 1}`.'
                " The current type carries forward until the next marker.")
            with gr.Row():
                with gr.Column(scale=1):
                    regular_name = gr.Textbox(value="Regular", label="Speech type name")
                    regular_insert = gr.Button("Insert label", variant="secondary")
                regular_audio = gr.Audio(label="Regular reference audio", type="filepath", scale=2)
                regular_ref_text = gr.Textbox(label="Reference text (optional)", lines=4, scale=2)

            type_rows = []
            type_names = [regular_name]
            type_audios = [regular_audio]
            type_ref_texts = [regular_ref_text]
            type_delete_btns = []
            type_insert_btns = [regular_insert]
            for i in range(1, MAX_SPEECH_TYPES):
                with gr.Row(visible=False) as row:
                    with gr.Column(scale=1):
                        name_in = gr.Textbox(label="Speech type name")
                        delete_btn = gr.Button("Delete type", variant="secondary")
                        insert_btn = gr.Button("Insert label", variant="secondary")
                    audio_in = gr.Audio(label="Reference audio", type="filepath", scale=2)
                    ref_text_in = gr.Textbox(label="Reference text (optional)", lines=4, scale=2)
                type_rows.append(row)
                type_names.append(name_in)
                type_audios.append(audio_in)
                type_ref_texts.append(ref_text_in)
                type_delete_btns.append(delete_btn)
                type_insert_btns.append(insert_btn)

            add_btn = gr.Button("Add speech type")
            type_count = gr.State(value=1)

            def add_speech_type(count):
                row_updates = [gr.update(visible=(i + 1 < count + 1)) for i in range(MAX_SPEECH_TYPES - 1)]
                if count < MAX_SPEECH_TYPES:
                    count += 1
                    row_updates[count - 2] = gr.update(visible=True)
                else:
                    gr.Warning("Exhausted maximum number of speech types.")
                return [count] + row_updates

            add_btn.click(add_speech_type, inputs=[type_count], outputs=[type_count] + type_rows)

            def make_delete(idx):
                def delete(count):
                    return [count - 1, gr.update(visible=False), None, None, None]
                return delete

            for i, btn in enumerate(type_delete_btns):
                btn.click(make_delete(i), inputs=[type_count],
                          outputs=[type_count, type_rows[i], type_names[i + 1],
                                   type_audios[i + 1], type_ref_texts[i + 1]])

            with gr.Row():
                gen_text_multistyle = gr.Textbox(
                    label="Script with {Type} markers", lines=10, scale=4,
                    placeholder="{Regular} Hello there!\n{Surprised} Oh, it's you!")
                gen_text_file_multistyle = gr.File(label="Load script from .txt", file_types=[".txt"], scale=1)

            def make_insert(name_comp_idx):
                def insert(current_text, name, count):
                    return [(current_text or "") + f"{{{name or ''}}} ", count]
                return insert

            for i, btn in enumerate(type_insert_btns):
                btn.click(make_insert(i), inputs=[gen_text_multistyle, type_names[i], type_count],
                          outputs=[gen_text_multistyle, type_count])

            with gr.Accordion("Advanced settings", open=False):
                remove_silence_multistyle = gr.Checkbox(label="Remove silences", value=True)
                nfe_multistyle = gr.Slider(4, 64, value=32, step=2, label="NFE steps")
            generate_multistyle_btn = gr.Button("Generate multi-style speech", variant="primary")
            audio_output_multistyle = gr.Audio(label="Synthesized audio")
            meta_multistyle = gr.Textbox(label="Inference metadata (per-segment name/seed/speed)", lines=4)

            gen_text_file_multistyle.upload(
                lambda f: gr.update(value=L.load_text_from_file(f)),
                inputs=[gen_text_file_multistyle], outputs=[gen_text_multistyle])

            def generate_multistyle_speech(gen_text_v, *args):
                names = args[:MAX_SPEECH_TYPES]
                audios = args[MAX_SPEECH_TYPES:2 * MAX_SPEECH_TYPES]
                ref_texts = args[2 * MAX_SPEECH_TYPES:3 * MAX_SPEECH_TYPES]
                remove_silence_v = args[3 * MAX_SPEECH_TYPES]
                nfe_v = args[3 * MAX_SPEECH_TYPES + 1]
                speech_types = L.collect_speech_types(names, audios, ref_texts)
                segments = L.parse_speechtypes_text(gen_text_v)

                out, meta, sr = [], "", None
                current = "Regular"
                for seg in segments:
                    if seg["name"] in speech_types:
                        current = seg["name"]
                    else:
                        gr.Warning(f"Type {seg['name']} is not available, will use Regular as default.")
                        current = "Regular"
                    if current not in speech_types or not speech_types[current]["audio"]:
                        gr.Warning(f"Please provide reference audio for type {current}.")
                        return [None] + [speech_types[n]["ref_text"] for n in speech_types] + [None]
                    seed = L.normalize_seed(int(seg.get("seed", -1)))
                    audio, _, ref_text_out, _ = infer(
                        speech_types[current]["audio"], speech_types[current]["ref_text"],
                        seg["text"], remove_silence_v, seed,
                        cross_fade_duration=0, nfe_step=nfe_v, speed=seg.get("speed", 1.0))
                    if audio is None:
                        return [None] + [speech_types[n]["ref_text"] for n in speech_types] + [None]
                    sr, wav = audio
                    out.append(wav)
                    speech_types[current]["ref_text"] = ref_text_out
                    meta += json.dumps(dict(name=seg["name"], seed=seed,
                                            speed=seg.get("speed", 1.0))) + f" {seg['text']}\n"
                if not out:
                    gr.Warning("No audio generated.")
                    return [None] + [speech_types[n]["ref_text"] for n in speech_types] + [None]
                return ([(sr, np.concatenate(out))]
                        + [speech_types[n]["ref_text"] for n in speech_types] + [meta])

            generate_multistyle_btn.click(
                generate_multistyle_speech,
                inputs=[gen_text_multistyle] + type_names + type_audios + type_ref_texts
                       + [remove_silence_multistyle, nfe_multistyle],
                outputs=[audio_output_multistyle] + type_ref_texts + [meta_multistyle])

            def validate_speech_types(gen_text_v, regular_name_v, *names):
                missing = L.missing_speech_types(gen_text_v, regular_name_v, *names)
                return gr.update(interactive=not missing)

            gen_text_multistyle.change(
                validate_speech_types,
                inputs=[gen_text_multistyle, regular_name] + type_names[1:],
                outputs=generate_multistyle_btn)

        # ------------------------------------------------------- Voice Chat --
        with gr.Tab("Voice-Chat"):
            gr.Markdown(
                "# Voice Chat\nHave a conversation with an AI using your"
                " reference voice. Needs a local chat-LLM snapshot"
                " ($F5_TTS_TPU_CHAT_MODEL) and a local Whisper for mic input.")
            chat_model_state = {"pipe": None}

            def load_chat_model():
                model_path = os.environ.get("F5_TTS_TPU_CHAT_MODEL")
                if not model_path:
                    raise gr.Error("set $F5_TTS_TPU_CHAT_MODEL to a local chat model path")
                if chat_model_state["pipe"] is None:
                    from transformers import pipeline as hf_pipeline

                    chat_model_state["pipe"] = hf_pipeline(
                        "text-generation", model=model_path, device="cpu")
                return gr.update(visible=False), gr.update(visible=True)

            load_chat_model_btn = gr.Button("Load chat model", variant="primary")
            chat_interface = gr.Column(visible=False)
            with chat_interface:
                with gr.Row():
                    with gr.Column():
                        ref_audio_chat = gr.Audio(label="Reference audio", type="filepath")
                    with gr.Column():
                        with gr.Accordion("Advanced settings", open=False):
                            remove_silence_chat = gr.Checkbox(label="Remove silences", value=True)
                            with gr.Row():
                                randomize_seed_chat = gr.Checkbox(label="Randomize seed", value=True)
                                seed_chat = gr.Number(label="Seed", value=0, precision=0)
                            ref_text_chat = gr.Textbox(label="Reference text", lines=2)
                            system_prompt_chat = gr.Textbox(
                                label="System prompt", value=L.DEFAULT_CHAT_SYSTEM_PROMPT, lines=2)
                chatbot_interface = gr.Chatbot(label="Conversation", type="messages")
                with gr.Row():
                    with gr.Column():
                        audio_input_chat = gr.Microphone(label="Speak your message", type="filepath")
                        audio_output_chat = gr.Audio(autoplay=True)
                    with gr.Column():
                        text_input_chat = gr.Textbox(label="Type your message", lines=1)
                        send_btn_chat = gr.Button("Send message")
                        clear_btn_chat = gr.Button("Clear conversation")

            load_chat_model_btn.click(load_chat_model, outputs=[load_chat_model_btn, chat_interface])

            def process_user_input(conv_state, audio_path, text):
                if audio_path and not (text or "").strip():
                    try:
                        text = ensure_model().transcribe(audio_path)
                    except Exception as e:  # no local whisper snapshot
                        gr.Warning(f"mic transcription unavailable: {e}")
                return L.conversation_add_user(conv_state or [], text)

            def generate_text_response(conv_state, system_prompt):
                pipe = chat_model_state["pipe"]
                if pipe is None or not conv_state:
                    return conv_state
                msgs = [{"role": "system", "content": system_prompt}] + [
                    {"role": m["role"],
                     "content": m["content"][0]["text"] if isinstance(m["content"], list) else m["content"]}
                    for m in conv_state]
                out = pipe(msgs, max_new_tokens=512)
                reply = out[0]["generated_text"][-1]["content"]
                return conv_state + [{"role": "assistant", "content": reply}]

            def generate_audio_response(conv_state, ref_audio_v, ref_text_v,
                                        remove_silence_v, randomize_v, seed_v):
                reply = L.last_assistant_reply(conv_state or [])
                if not reply or not ref_audio_v:
                    return None, ref_text_v, seed_v
                seed_v = L.normalize_seed(int(seed_v or 0), randomize=bool(randomize_v))
                audio, _, ref_text_out, used_seed = infer(
                    ref_audio_v, ref_text_v, reply, remove_silence_v, seed_v)
                return audio, ref_text_out, used_seed

            for user_op in (audio_input_chat.stop_recording, text_input_chat.submit,
                            send_btn_chat.click):
                user_op(
                    process_user_input,
                    inputs=[chatbot_interface, audio_input_chat, text_input_chat],
                    outputs=[chatbot_interface],
                ).then(
                    generate_text_response,
                    inputs=[chatbot_interface, system_prompt_chat],
                    outputs=[chatbot_interface],
                ).then(
                    generate_audio_response,
                    inputs=[chatbot_interface, ref_audio_chat, ref_text_chat,
                            remove_silence_chat, randomize_seed_chat, seed_chat],
                    outputs=[audio_output_chat, ref_text_chat, seed_chat],
                ).then(
                    lambda: (None, None), outputs=[audio_input_chat, text_input_chat])

            for op in (clear_btn_chat.click, system_prompt_chat.change, chatbot_interface.clear):
                op(lambda: ([], None), outputs=[chatbot_interface, audio_output_chat])

        # ---------------------------------------------------------- Credits --
        with gr.Tab("Credits"):
            gr.Markdown(
                "PyTorch / CUDA rebuild of [F5-TTS](https://github.com/SWivid/F5-TTS)."
                " UI layout follows the reference Gradio app (mrfakename's"
                " original demo; jpgallegoar's multi-speech & voice chat).")
    return app


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="f5-tts_infer-gradio")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--share", action="store_true")
    p.add_argument("--api", action="store_true", default=True)
    p.add_argument("--root_path", default=None)
    p.add_argument("--inbrowser", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    app = build_app(device=args.device)
    app.queue(api_open=args.api).launch(
        server_name=args.host, server_port=args.port, share=args.share,
        show_api=args.api, root_path=args.root_path, inbrowser=args.inbrowser)


if __name__ == "__main__":
    main()
