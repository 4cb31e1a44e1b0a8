"""Port parity for the dataset processors and brain projection: the port's
assembly generators, context policies, word rates, analysis mask,
temporal baseline, transcript reader, VolumeProcessor and surface cache
against the JAX package's on the same inputs. The JAX functions take
pandas DataFrames; the port's take the same DataFrames or its own mapping
of numpy columns, and neither may change a stimulus, word, word rate, TR
time or response. NIfTI reads stay out (no nibabel here): the Narratives
and LPP generators take their responses from a seeded surface cache, keyed
on placeholder files with the BIDS names, which is their cache-hit path."""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from litcoder_core_torch.assembly import AssemblyGenerator
from litcoder_core_torch.assembly.base_processor import BaseAssemblyGenerator
from litcoder_core_torch.assembly.lebel_processor import (
    LEBEL_STORIES,
    LebelAssemblyGenerator,
)
from litcoder_core_torch.brain_projection import simple_cache
from litcoder_core_torch.brain_projection.project import VolumeProcessor
from litcoder_core_torch.brain_projection.simple_cache import (
    SimpleSurfaceCache,
)

REPO = Path(__file__).resolve().parent.parent
NARR_BOLD = ("{subject}_task-21styear_space-MNI152NLin2009cAsym_res-2_desc-"
             "preproc_bold.nii.gz")
LPP_BOLD = ("{subject}_task-lppEN_run-{run}_space-MNI152NLin2009cAsym_res-2_"
            "desc-preproc_bold_fixed.nii.gz")


class WordTokenizer:
    """Offline tokenizer: one token per whitespace word."""

    def encode(self, text, add_special_tokens=False):
        return text.split()

    def decode(self, tokens):
        return " ".join(tokens)


def _jax():
    import litcoder_core_tpu.assembly as jax_assembly

    return jax_assembly


def _pair(tmp_path, tr=2.0, **kw):
    """(port generator, JAX generator) of LeBel type, word tokenizer."""
    args = dict(data_dir=str(tmp_path), dataset_type="lebel", tr=tr,
                use_volume=True, tokenizer=WordTokenizer(), **kw)
    return (LebelAssemblyGenerator(**args),
            _jax().LebelAssemblyGenerator(**args))


def _words(rng, n, empty_every=7):
    words = [f"w{int(k)}" for k in rng.integers(0, 50, n)]
    for i in range(3, n, empty_every):
        words[i] = ""
    words[1] = "  "  # whitespace only: a word for context, not for rates
    return words


def _transcripts(words, times):
    df = pd.DataFrame({"word_orig": words, "word_times": times})
    mapping = {"word_orig": np.array(words, dtype=object),
               "word_times": np.asarray(times, float)}
    return df, mapping


@pytest.mark.parametrize("policy", ["fullcontext", "nocontext",
                                    "halfcontext"])
@pytest.mark.parametrize("lookback", [2, 3, 8])
def test_context_policies_match_jax(tmp_path, policy, lookback):
    rng = np.random.default_rng(lookback)
    words = _words(rng, 40)
    df, mapping = _transcripts(words, np.arange(40.0))
    port, ref = _pair(tmp_path)
    for gen in (port, ref):
        gen.context_type = policy
    want = ref.generate_stimuli_with_context(df, lookback)
    assert port.generate_stimuli_with_context(df, lookback) == want
    assert port.generate_stimuli_with_context(mapping, lookback) == want
    assert len(want) == 40 and want[3] == ""


def test_invalid_context_type_raises(tmp_path):
    port, _ = _pair(tmp_path)
    port.context_type = "bogus"
    with pytest.raises(ValueError, match="Invalid context type"):
        port.generate_stimuli_with_context(
            {"word_orig": np.array(["a"], dtype=object),
             "word_times": np.zeros(1)}, 3)


def test_word_rates_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    tr_times = np.arange(0.0, 20.0, 2.0)
    times = np.sort(rng.uniform(0, 22, 60))
    times[5] = 20.0 + 2.0  # exactly at the last edge: dropped
    times[6] = tr_times[3]  # exactly on a bin's left edge
    words = _words(rng, 60, empty_every=5)
    words[8] = np.nan  # pandas reads it as 'nan', a word
    df, mapping = _transcripts(words, times)
    port, ref = _pair(tmp_path)
    want = ref.compute_word_rate_features(df, tr_times)
    for transcript in (df, mapping):
        got = port.compute_word_rate_features(transcript, tr_times)
        assert got.shape == (10, 1) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_analysis_mask_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    data = rng.normal(size=(5, 6))
    port, ref = _pair(tmp_path)
    for mask in (None, np.array([1, 0, 1, 1, 0, 0], bool)):
        port.analysis_mask = ref.analysis_mask = mask
        (gm, gi), (wm, wi) = (port.apply_analysis_mask(data),
                              ref.apply_analysis_mask(data))
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gi, wi)
    port.analysis_mask = np.array([True])
    with pytest.raises(ValueError, match="doesn't match"):
        port.apply_analysis_mask(data)


@pytest.mark.parametrize("n,d_model,length", [(60, 60, 10), (20, 128, 5),
                                              (50, 8, 75)])
def test_temporal_baseline_matches_jax(tmp_path, n, d_model, length):
    """Column signs of an eigenbasis are free, so F F^T is compared."""
    port, ref = _pair(tmp_path)
    got = port.create_temporal_baseline(["x"] * n, d_model, length)
    want = ref.create_temporal_baseline(["x"] * n, d_model, length)
    assert got.shape == want.shape == (n, min(n, d_model))
    np.testing.assert_allclose(got @ got.T, want @ want.T, atol=1e-10)
    if d_model >= n:
        idx = np.arange(n)
        np.testing.assert_allclose(
            got @ got.T, np.exp(-np.abs(idx[:, None] - idx[None]) / length),
            atol=1e-6)


def _write_transcripts(data_dir, dataset_type, stories, n_trs, rng,
                       n_words=30, tr=2.0, tr_onset=None):
    records = []
    for s in stories:
        records.append({
            "story_name": s,
            "words": _words(rng, n_words),
            "split_indices": sorted(rng.integers(0, n_trs, n_words).tolist()),
            "tr_times": np.arange(n_trs) * tr,
            "data_times": np.sort(rng.uniform(0, n_trs * tr, n_words)),
            **({"TR_onset": tr_onset} if tr_onset is not None else {}),
        })
    with open(Path(data_dir) / f"{dataset_type}_data.pkl", "wb") as f:
        pickle.dump(records, f)


def test_process_transcript_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    _write_transcripts(tmp_path, "lebel", ["adollshouse", "buck"], 12, rng)
    port, ref = _pair(tmp_path)
    got = port.process_transcript(str(tmp_path), "buck")
    want = ref.process_transcript(str(tmp_path), "buck")
    assert isinstance(got[0], dict) and set(got[0]) == {"word_orig",
                                                        "word_times"}
    assert list(got[0]["word_orig"]) == want[0]["word_orig"].tolist()
    np.testing.assert_array_equal(got[0]["word_times"],
                                  want[0]["word_times"].to_numpy())
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for gen in (port, ref):
        with pytest.raises(ValueError, match="not found in lebel_data.pkl"):
            gen.process_transcript(str(tmp_path), "nonexistent_story")


def _assert_assemblies_equal(got, want):
    assert type(got).__module__.startswith("litcoder_core_torch")
    assert got.stories == want.stories
    assert got.get_validation_method() == want.get_validation_method()
    np.testing.assert_array_equal(got.data, want.data)
    for name in want.stories:
        g, w = got.story_data[name], want.story_data[name]
        for field in dataclasses.fields(w):
            a, b = getattr(g, field.name), getattr(w, field.name)
            if field.name == "temporal_baseline" and b is not None:
                np.testing.assert_allclose(a @ a.T, b @ b.T, atol=1e-10)
            elif isinstance(b, (list, str)) or b is None:
                assert a == b, (name, field.name)
            else:
                assert np.asarray(a).dtype == np.asarray(b).dtype, field.name
                np.testing.assert_array_equal(a, b, err_msg=field.name)


@pytest.fixture
def lebel_dir(tmp_path):
    rng = np.random.default_rng(9)
    stories = ["adollshouse", "adventuresinsayingyes"]
    _write_transcripts(tmp_path, "lebel", stories, 12, rng)
    for subject in ("UTS03", "UTS99"):
        responses = {s: rng.normal(size=(12, 7)).astype(np.float32)
                     for s in stories}
        with open(tmp_path / f"noslice_sub-{subject}_story_data.pkl",
                  "wb") as f:
            pickle.dump(responses, f)
    return tmp_path, stories


@pytest.mark.parametrize("context_type,baseline", [
    ("fullcontext", False), ("nocontext", True), ("halfcontext", False)])
def test_lebel_generator_matches_jax(lebel_dir, context_type, baseline):
    data_dir, stories = lebel_dir
    mask = np.array([1, 1, 0, 1, 0, 1, 1], bool)
    assemblies = []
    for gen in _pair(data_dir, analysis_mask_path=mask):
        gen.stories = stories
        assemblies.append(gen.generate_assembly(
            "UTS03", lookback=5, context_type=context_type,
            correlation_length=10, generate_temporal_baseline=baseline))
    _assert_assemblies_equal(*assemblies)
    sd = assemblies[0].story_data[stories[0]]
    assert sd.brain_data.shape == (12, 5)
    assert sd.audio_path == f"{data_dir}/audio_files/adollshouse.wav"
    assert assemblies[0].get_validation_method() == "outer"


def test_lebel_multi_subject_cache_not_stale(lebel_dir):
    data_dir, stories = lebel_dir
    port, ref = _pair(data_dir)
    for gen in (port, ref):
        gen.stories = stories
    for subject in ("UTS03", "UTS99", "UTS03"):
        got = port.generate_assembly(subject, lookback=5)
        _assert_assemblies_equal(got, ref.generate_assembly(subject,
                                                            lookback=5))
    with open(data_dir / "noslice_sub-UTS99_story_data.pkl", "rb") as f:
        want = pickle.load(f)
    got = port.generate_assembly("UTS99", lookback=5)
    np.testing.assert_array_equal(got.story_data[stories[0]].brain_data,
                                  want[stories[0]])
    assert LEBEL_STORIES == _jax().lebel_processor.LEBEL_STORIES


@pytest.fixture
def surface_caches(tmp_path, monkeypatch):
    """Both packages' surface-cache singletons pointed at one fresh
    directory (the entries are the same files)."""
    from litcoder_core_tpu.brain_projection import (
        simple_cache as jax_simple_cache,
    )

    cache_dir = str(tmp_path / "surface_cache")
    monkeypatch.setattr(simple_cache, "_GLOBAL_CACHE", None)
    monkeypatch.setattr(jax_simple_cache, "_GLOBAL_CACHE", None)
    simple_cache.get_surface_cache(cache_dir)
    jax_simple_cache.get_surface_cache(cache_dir)
    return SimpleSurfaceCache(cache_dir)


def test_narratives_generator_matches_jax(tmp_path, surface_caches):
    """21styear: the BOLD placeholder found by its BIDS name, the audio next
    to the transcript, the responses from the surface cache."""
    rng = np.random.default_rng(21)
    data_dir = tmp_path / "narratives"
    subject_dir = data_dir / "sub-256"
    subject_dir.mkdir(parents=True)
    bold = subject_dir / NARR_BOLD.format(subject="sub-256")
    bold.write_bytes(b"")
    (data_dir / "21styear.wav").write_bytes(b"")
    _write_transcripts(data_dir, "narratives", ["21styear"], 20, rng,
                       n_words=50, tr=1.5)
    responses = rng.normal(size=(20, 9)).astype(np.float32)
    surface_caches.set("sub-256", str(bold), responses)

    kw = dict(dataset_type="narratives", data_dir=str(data_dir),
              subject="sub-256", tr=1.5, lookback=6,
              tokenizer=WordTokenizer())
    got = AssemblyGenerator.generate_assembly(**kw)
    want = _jax().AssemblyGenerator.generate_assembly(**kw)
    _assert_assemblies_equal(got, want)
    sd = got.story_data["21styear"]
    np.testing.assert_array_equal(sd.brain_data, responses)
    assert sd.audio_path == str(data_dir / "21styear.wav")
    assert got.get_validation_method() == "inner"
    with pytest.raises(FileNotFoundError, match="Subject directory"):
        AssemblyGenerator.generate_assembly(**dict(kw, subject="sub-000"))
    (subject_dir / "sub-002").mkdir()
    with pytest.raises(ValueError, match="No stories found"):
        AssemblyGenerator.generate_assembly(**dict(kw, subject="sub-256/"
                                                   "sub-002"))


def test_lpp_generator_matches_jax(tmp_path, surface_caches):
    """Two runs: the first 4 TRs dropped, then the rows at TR_onset in the
    iteration order of its set, which here is not sorted order."""
    rng = np.random.default_rng(5)
    data_dir = tmp_path / "lpp"
    subject_dir = data_dir / "sub-EN057"
    subject_dir.mkdir(parents=True)
    tr_onset = [40, 1, 33, 33, 8, 17, 1, 25]
    rows = [int(t) for t in set(tr_onset)]
    assert rows != sorted(rows)
    _write_transcripts(data_dir, "lpp", ["run_01", "run_02"], len(rows), rng,
                       tr_onset=tr_onset)
    for run in ("01", "02"):
        bold = subject_dir / LPP_BOLD.format(subject="sub-EN057", run=run)
        bold.write_bytes(b"")
        surface_caches.set("sub-EN057", str(bold),
                           rng.normal(size=(50, 6)).astype(np.float32))
    kw = dict(dataset_type="lpp", data_dir=str(data_dir),
              subject="sub-EN057", tr=2.0, lookback=4,
              context_type="halfcontext", tokenizer=WordTokenizer())
    got = AssemblyGenerator.generate_assembly(**kw)
    want = _jax().AssemblyGenerator.generate_assembly(**kw)
    _assert_assemblies_equal(got, want)
    assert got.stories == ["run_01", "run_02"]
    bold = subject_dir / LPP_BOLD.format(subject="sub-EN057", run="01")
    full = surface_caches.get("sub-EN057", str(bold))
    np.testing.assert_array_equal(got.story_data["run_01"].brain_data,
                                  full[4:][rows])
    assert got.story_data["run_01"].audio_path is None
    from litcoder_core_torch.assembly import LPPAssemblyGenerator

    gen = LPPAssemblyGenerator(str(data_dir), "lpp")
    assert gen.tr == 2.0  # LPP's default; AssemblyGenerator passes 1.5
    assert [c["section"] for c in gen._discover_stories(subject_dir)] == [1, 2]


def test_generator_factory():
    with pytest.raises(ValueError, match="Unsupported dataset type"):
        AssemblyGenerator.create("bogus", "/tmp")
    for name, cls in AssemblyGenerator._generators.items():
        gen = AssemblyGenerator.create(name, "/tmp", tokenizer=WordTokenizer())
        assert isinstance(gen, cls) and isinstance(gen, BaseAssemblyGenerator)
        assert gen.tokenizer.encode("a b") == ["a", "b"]
        assert (type(gen).__name__ ==
                type(_jax().AssemblyGenerator.create(name, "/tmp")).__name__)


@pytest.mark.parametrize("masked", [False, True])
def test_volume_processor_matches_jax(masked):
    from litcoder_core_tpu.brain_projection.project import (
        VolumeProcessor as JaxVolume,
    )

    rng = np.random.default_rng(7)
    vol = rng.normal(size=(4, 5, 6, 10)).astype(np.float32)
    mask = rng.uniform(size=(4, 5, 6)) > 0.5 if masked else None
    got = VolumeProcessor(mask=mask).process_brain_data(vol, np.eye(4))
    want = JaxVolume(mask=mask).process_brain_data(vol, np.eye(4))
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.shape == (10, mask.sum() if masked else 120)
    np.testing.assert_array_equal(
        got.data[3], vol[:, :, :, 3][mask] if masked
        else vol[:, :, :, 3].reshape(-1))
    if masked:
        with pytest.raises(ValueError, match="does not match"):
            VolumeProcessor(mask=mask[:2]).process_brain_data(vol, np.eye(4))


def test_surface_cache_round_trip_and_cross_package(tmp_path):
    from litcoder_core_tpu.brain_projection.simple_cache import (
        SimpleSurfaceCache as JaxCache,
    )

    rng = np.random.default_rng(8)
    cache = SimpleSurfaceCache(str(tmp_path / "c"))
    vol = tmp_path / "vol.nii.gz"
    vol.write_bytes(b"fake")
    data = rng.normal(size=(5, 9))
    assert cache.get("sub1", str(vol)) is None
    cache.set("sub1", str(vol), data)
    np.testing.assert_array_equal(cache.get("sub1", str(vol)), data)
    np.testing.assert_array_equal(JaxCache(str(tmp_path / "c")).get(
        "sub1", str(vol)), data)
    JaxCache(str(tmp_path / "c")).set("sub2", str(vol), 2 * data)
    np.testing.assert_array_equal(cache.get("sub2", str(vol)), 2 * data)
    assert not list((tmp_path / "c").glob(".*tmp*"))
    # The key holds the file's mtime: touching it invalidates the entry.
    os.utime(vol, (1e9, 1e9))
    assert cache.get("sub1", str(vol)) is None
    cache.clear()
    assert not list((tmp_path / "c").glob("*.npy"))


def test_surface_cache_corrupt_entry_recovers(tmp_path):
    cache = SimpleSurfaceCache(str(tmp_path / "cache"))
    vol = tmp_path / "vol.nii.gz"
    vol.write_bytes(b"x")
    cache.set("s1", str(vol), np.ones((3, 4), np.float32))
    entry = next((tmp_path / "cache").glob("*.npy"))
    entry.write_bytes(b"not a npy file")
    assert cache.get("s1", str(vol)) is None
    assert not entry.exists()


def test_surface_cache_singleton_redirect(tmp_path, monkeypatch):
    monkeypatch.setattr(simple_cache, "_GLOBAL_CACHE", None)
    monkeypatch.chdir(tmp_path)
    default = simple_cache.get_surface_cache()
    assert str(default.cache_dir) == "surface_cache"
    a = simple_cache.get_surface_cache(str(tmp_path / "a"))
    assert a is not default
    assert simple_cache.get_surface_cache() is a
    assert simple_cache.get_surface_cache(str(tmp_path / "a")) is a
    b = simple_cache.get_surface_cache(str(tmp_path / "b"))
    assert b is not a and str(b.cache_dir) == str(tmp_path / "b")


def test_assembly_package_imports_without_pandas(tmp_path):
    """The card's machine may lack pandas, nibabel and nilearn: the
    processors import, and read a transcript, with pandas blocked."""
    _write_transcripts(tmp_path, "lebel", ["buck"], 6,
                       np.random.default_rng(0), n_words=10)
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import litcoder_core_torch.assembly as a\n"
        "import litcoder_core_torch.brain_projection\n"
        "import litcoder_core_torch\n"
        "gen = a.AssemblyGenerator.create('lebel', sys.argv[1])\n"
        "t, *_ = gen.process_transcript(sys.argv[1], 'buck')\n"
        "print(len(t['word_orig']))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('pandas', 'nibabel', 'nilearn', 'transformers'))\n"
        "assert bad == ['pandas'], bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "10"
