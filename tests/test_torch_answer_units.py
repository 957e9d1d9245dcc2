"""``server/answer_units.py`` of both packages: the port's is a
verbatim copy (pinned in tests/test_torch_host_copies.py), and the
answer-unit cases of tests/test_response_layer.py and
tests/test_orchestration.py run against each package's module."""

import importlib

import pytest


@pytest.fixture(params=["legal_rag_tpu", "legal_rag_tpu_torch"])
def au(request):
    return importlib.import_module(f"{request.param}.server.answer_units")


def _chunk(au, text, sid="GSOP_004", start=0):
    return au.ChunkWithOffsets(
        doc_id="GENERAL_SOP", section_id=sid, text=text,
        start_char=start, end_char=start + len(text),
    )


def test_span_exact_and_normalized_resolution(au):
    chunks = [_chunk(au,
        "Every citizen has the right to file FIR immediately at any "
        "police station."
    )]
    span = au.resolve_span("file FIR immediately", chunks)
    assert span is not None and span.section_id == "GSOP_004"
    assert "FIR immediately" in span.quote

    messy = [_chunk(au, "The   victim   should   file    FIR.")]
    span = au.resolve_span("victim should file FIR", messy)
    assert span is not None
    assert span.quote.startswith("victim")


def test_span_offsets_respect_chunk_base(au):
    chunks = [_chunk(au, "Preamble. File FIR immediately.", start=100)]
    span = au.resolve_span("File FIR immediately", chunks)
    assert span.start_char == 110
    assert span.end_char == 130


def test_span_no_match_and_empty_inputs(au):
    assert au.resolve_span("quote", []) is None
    assert au.resolve_span("", [_chunk(au, "text")]) is None
    assert au.resolve_span("does not exist anywhere", [_chunk(au, "other")]) is None


def test_resolve_all_downgrades_unresolvable_verbatim(au):
    units = [
        au.AnswerUnit(id="S1", text="Real.", kind="verbatim",
                      quote="File FIR"),
        au.AnswerUnit(id="S2", text="Synth.", kind="derived"),
        au.AnswerUnit(id="S3", text="Fake.", kind="verbatim",
                      quote="made up quote zzz qqq xxx"),
    ]
    chunks = [_chunk(au, "File FIR at the police station.")]
    out = au.resolve_all_spans(units, chunks)
    assert out[0].kind == "verbatim" and out[0].is_clickable
    assert out[1].kind == "derived"
    assert out[2].kind == "derived" and out[2].source_spans == []


def test_clickability_invariants(au):
    derived = au.AnswerUnit(id="S1", text="t", kind="derived")
    derived.source_spans.append(
        au.SourceSpan("D", "001", 0, 4, "fake")
    )
    assert derived.is_clickable is False  # derived NEVER clickable
    verbatim = au.AnswerUnit(id="S2", text="t", kind="verbatim", quote="q")
    assert verbatim.is_clickable is False  # no span resolved yet


@pytest.mark.parametrize("payload,expect", [
    ('{"answer_units": []}', "{"),
    ('```json\n{"answer_units": []}\n```', "{"),
    ('```\n{"answer_units": []}\n```', "{"),
    ('Here it is:\n\n{"answer_units": []}', "{"),
])
def test_json_extraction_formats(au, payload, expect):
    import json
    extracted = au._extract_json_from_response(payload)
    assert extracted.startswith(expect)
    assert "```" not in extracted
    assert "answer_units" in json.loads(extracted)


def test_json_extraction_nested_braces_and_trailing_text(au):
    import json
    payload = '{"answer_units": [{"text": "Use {curly} braces", "kind": "derived"}]}'
    assert json.loads(au._extract_json_from_response(payload))[
        "answer_units"][0]["text"] == "Use {curly} braces"
    payload2 = '```json\n{"answer_units": []}\n```\n\nnotes after.'
    assert json.loads(au._extract_json_from_response(payload2)) == {
        "answer_units": []
    }


def test_parse_answer_units(au):
    units = au.parse_answer_units_response("""
    {"answer_units": [
        {"id": "S1", "text": "File FIR immediately.", "kind": "verbatim",
         "quote": "File FIR"},
        {"id": "S2", "text": "Preserve evidence.", "kind": "derived",
         "supporting_sources": ["GSOP_004"]}
    ]}""")
    assert [u.kind for u in units] == ["verbatim", "derived"]
    assert units[0].quote == "File FIR"
    assert units[1].supporting_sources == ["GSOP_004"]
    # garbage -> [] (legacy path)
    assert au.parse_answer_units_response("not json at all") == []
    # verbatim without quote downgrades
    u = au.parse_answer_units_response(
        '{"answer_units": [{"id": "S1", "text": "x", "kind": "verbatim"}]}'
    )
    assert u[0].kind == "derived"


def test_answer_unit_prompt_contract(au):
    p = au.get_answer_unit_prompt("Section 183 BNSS states...", "What?")
    assert "Section 183 BNSS" in p and "What?" in p
    assert "JSON" in p and "answer_units" in p
    assert "verbatim" in p.lower() and "derived" in p.lower()


@pytest.mark.parametrize("raw,expected", [
    ("GSOP_057", "GSOP_057"),
    ("gsop_004 - SOP ON RECEIPT", "GSOP_004"),
    ("Section 173 BNSS", "173"),
    ("section 183", "183"),
    ("BNSS Section 244", "244"),
    ("BNSS_183", "183"),
    ("BNS-351", "351"),
    ("BSA 147", "147"),
    ("183", "183"),
    ("  351  ", "351"),
])
def test_extract_section_id(au, raw, expected):
    assert au._extract_section_id(raw) == expected


def test_extract_section_id_truncates_long_junk(au):
    junk = "An extremely long source description with no id whatsoever in it"
    out = au._extract_section_id(junk)
    assert out.endswith("...") and len(out) <= 28


def test_clean_supporting_sources(au):
    cleaned = au._clean_supporting_sources(
        ["GSOP_004", 123, None, "Section 183", "GSOP_004"]
    )
    assert cleaned == ["GSOP_004", "183"]
    assert au._clean_supporting_sources(None) == []
    assert au._clean_supporting_sources([]) == []


def test_normalize_and_fuzzy_helpers(au):
    assert au._normalize_text("  Hello   World  ") == "hello world"
    assert au._normalize_text("Multiple\n\nNewlines") == "multiple newlines"
    assert au._fuzzy_find("xyz123", "completely different text", 0.8) is None
    hit = au._fuzzy_find(
        "Electronic communication should be sent to official email",
        "Electronic communication should preferably be sent to the "
        "official email address of the SHO",
        0.75,
    )
    assert hit is None or isinstance(hit, tuple)


def test_parse_answer_units_top_level_array_is_garbage(au):
    assert au.parse_answer_units_response(
        '[{"text": "x", "kind": "derived"}]') == []
