"""The port's CLI, ChatML recipe and entry step, against the JAX
package's, exactly."""

import json

import numpy as np
import pytest
import torch

from jtokkit_tpu import Encodings as JaxEncodings
from jtokkit_tpu import cli as jax_cli
from jtokkit_tpu.recipes import chatml as jax_chatml
from jtokkit_tpu_torch import Encodings, SpecialTokenError, cli, entry
from jtokkit_tpu_torch.recipes.chatml import ChatMessage, count_message_tokens

torch.set_num_threads(1)


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["encode", "Hello, world! 中文 🙂"],
    ["encode", "--encoding", "r50k_base", "I'm 42 —  ok"],
    ["encode", "--ordinary", "a <|endoftext|> b"],
    ["decode", "9906", "11", "1917", "0"],
    ["decode", "--encoding", "p50k_base", "15496", "995"],
    ["count", "The quick brown fox jumps over the lazy dog."],
    ["count", "--ordinary", "--encoding", "p50k_edit", "<|endoftext|> twice"],
    ["info"],
], ids=lambda a: "-".join(a[:2]))
def test_cli_matches_jax(argv, capsys):
    port_argv = argv if argv[0] == "info" else argv + ["--device", "cpu"]
    assert _run(cli.main, port_argv, capsys) == _run(jax_cli.main, argv, capsys)


def test_cli_count_file_matches_jax(tmp_path, capsys):
    path = tmp_path / "corpus.txt"
    path.write_text("line one\nзначение 中文\n" * 50, encoding="utf-8")
    argv = ["count", "--file", str(path)]
    port = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert port == _run(jax_cli.main, argv, capsys)
    assert json.loads(port) > 0


def test_cli_special_token_raises_like_jax():
    errors = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        with pytest.raises(Exception) as info:
            main(["encode", "a <|endoftext|> b"] + extra)
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] == "SpecialTokenError"


def test_cli_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["encode", "Hello"])


MESSAGES = [
    ChatMessage("system", "You are a helpful assistant."),
    ChatMessage("user", "Count my tokens please!"),
    ChatMessage("user", "With a name too.", name="alice"),
]


@pytest.mark.parametrize("model", ["gpt-4", "gpt-4-0314", "gpt-3.5-turbo"])
def test_chatml_matches_jax(model):
    reg = Encodings.new_lazy_encoding_registry(device="cpu")
    jax_reg = JaxEncodings.new_lazy_encoding_registry()
    jax_messages = [
        jax_chatml.ChatMessage(m.role, m.content, m.name) for m in MESSAGES
    ]
    got = count_message_tokens(reg, model, MESSAGES)
    assert got == jax_chatml.count_message_tokens(jax_reg, model, jax_messages)
    enc = reg.get_encoding_for_model(model)
    content = sum(
        enc.count_tokens(m.content) + enc.count_tokens(m.role) for m in MESSAGES
    )
    per_message, per_name = (3, 1) if model.startswith("gpt-4") else (4, -1)
    names = enc.count_tokens("alice") + per_name
    assert got == content + names + per_message * len(MESSAGES) + 3


def test_chatml_errors():
    reg = Encodings.new_lazy_encoding_registry(device="cpu")
    for model in ("davinci", "unknown-model"):
        with pytest.raises(ValueError):
            count_message_tokens(reg, model, MESSAGES)
    with pytest.raises(SpecialTokenError):
        count_message_tokens(reg, "gpt-4", [ChatMessage("user", "hi <|endoftext|>")])


def test_entry_step_on_cpu_matches_jax():
    """One Stage A v4 + merge_rows_t3 step on the CPU, against the JAX
    package's ``__graft_entry__.entry`` on the same inputs."""
    import __graft_entry__ as graft

    fn, args = entry.entry(device="cpu")
    assert all(a.device == torch.device("cpu") for a in args)
    got = [np.asarray(x) for x in fn(*args)]
    jax_fn, jax_args = graft.entry()
    for a, b in zip(args, jax_args):
        assert np.array_equal(a.numpy(), np.asarray(b))
    want = [np.asarray(x) for x in jax_fn(*jax_args)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_entry_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
