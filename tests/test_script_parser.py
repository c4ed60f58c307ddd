from fandom_search.data.script_parser import parse_script


def test_tagged_format():
    text = "ALICE: Hello there.\nBOB: General Kenobi!\nALICE: You are bold."
    lines = parse_script(text)
    assert [ln.speaker for ln in lines] == ["ALICE", "BOB", "ALICE"]
    assert lines[1].text == "General Kenobi!"
    assert [ln.line_no for ln in lines] == [0, 1, 2]


def test_tagged_with_tabs_and_blank_lines():
    text = "ALICE\tHi.\n\nBOB\tBye.\n"
    lines = parse_script(text)
    assert len(lines) == 2
    assert lines[0].speaker == "ALICE" and lines[0].text == "Hi."


def test_screenplay_format():
    text = """
INT. CANTINA - NIGHT

ALICE
Hello there, my old friend.
It has been a while.

(beat)

BOB
General Kenobi!
"""
    lines = parse_script(text)
    assert lines[0].speaker == "" and lines[0].text.startswith("INT.")
    alice = [ln for ln in lines if ln.speaker == "ALICE"]
    assert len(alice) == 1  # wrapped speech merged into one record
    assert alice[0].text == "Hello there, my old friend. It has been a while."
    bob = [ln for ln in lines if ln.speaker == "BOB"]
    assert bob[0].text == "General Kenobi!"


def test_line_numbers_sequential():
    text = "A: one\nB: two\nC: three"
    lines = parse_script(text)
    assert [ln.line_no for ln in lines] == list(range(len(lines)))
