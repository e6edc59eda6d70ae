"""The port's text elements against gstpu's, on the CPU.

Twins of the text cases of tests/test_convert_text.py (`regex`,
`textwrap`, `jsongstenc ! jsongstparse`, `textaccumulate`,
`textahead`): the same inputs go through gstpu's element and the port's,
and every output's bytes, pts, duration and metas must be equal. Host
code in both packages, so there is no tolerance.
"""

import importlib

import pytest
import torch

import gstpu
import gstpu_torch

NAMES = ("gstpu", "gstpu_torch")


@pytest.fixture(autouse=True)
def _both_on_cpu():
    gstpu.init()
    gstpu_torch.init(device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mod(name: str, path: str):
    return importlib.import_module(f"{name}.{path}")


def _buf(b):
    return (b.to_bytes(), b.pts, b.duration,
            [(type(m).__name__, dict(vars(m))) for m in b.metas])


def _harness(name, element, texts, eos=False, **props):
    """`texts` pushed one a second into `element` of package `name`:
    every output buffer."""
    Harness = _mod(name, "core.harness").Harness
    Buffer = importlib.import_module(name).Buffer
    el = _mod(name, "core.registry").make(element)
    for k, v in props.items():
        el.set_property(k, v)
    h = Harness(el)
    h.set_caps("text/x-raw, format=utf8")
    for i, t in enumerate(texts):
        h.push(Buffer(t.encode(), pts=i * 10 ** 9, duration=10 ** 9))
    if eos:
        h.push_eos()
    out = [_buf(b) for b in h.pull_all()]
    h.teardown()
    return out


def _both(element, texts, eos=False, **props):
    ref, port = (_harness(n, element, texts, eos, **props) for n in NAMES)
    assert port == ref
    return port


def test_regex_element():
    out = _both("regex", ["the cat sat on the catalog", "cat. cat, bobcat"],
                commands=[{"operation": "replace-all",
                           "pattern": r"\bcat\b", "replacement": "dog"}])
    assert out[0][0] == b"the dog sat on the catalog"
    assert out[1][0] == b"dog. dog, bobcat"


def test_textwrap_element():
    out = _both("textwrap", ["hello wonderful world of text",
                             "a much longer line that wraps more than "
                             "once at ten columns"], columns=10)
    for b in out:
        assert all(len(line) <= 10 for line in b[0].decode().splitlines())


def test_json_roundtrip():
    def run(name):
        pkg = importlib.import_module(name)
        p = pkg.parse_launch("appsrc name=src ! jsongstenc ! tee name=t ! "
                             "queue ! jsongstparse ! appsink name=sink ! "
                             "t. ! queue ! appsink name=json")
        src = p.get_by_name("src")
        src.set_property("caps", _mod(name, "core.caps").parse_caps(
            "text/x-raw, format=utf8"))
        p.set_state(pkg.State.PLAYING)
        src.push_buffer(pkg.Buffer(b"line one\nline two", pts=5, duration=7))
        src.push_buffer(pkg.Buffer("café …".encode(), pts=12,
                                   duration=3))
        src.end_of_stream()
        p.run()
        out = {s: (repr(p.get_by_name(s).caps),
                   [_buf(b) for b in p.get_by_name(s).pull_all()])
               for s in ("sink", "json")}
        p.set_state(pkg.State.NULL)
        return out
    ref, port = (run(n) for n in NAMES)
    assert port == ref
    sink = port["sink"][1]
    assert sink[0][:3] == (b"line one\nline two", 5, 7)
    assert sink[1][:3] == ("café …".encode(), 12, 3)


def test_textaccumulate():
    out = _both("textaccumulate", ["hello", "world.", "again"])
    assert [b[0] for b in out] == [b"hello", b"hello world.", b"again"]
    assert ("TextAccumulateSentenceMeta", {"complete": True}) in out[1][3]


def test_textahead():
    out = _both("textahead", ["a", "b", "c"], eos=True, n_ahead=1)
    assert [b[0].decode() for b in out] == ["a\nb", "b\nc", "c"]
