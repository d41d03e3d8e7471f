"""Preset plumbing: the attention backend each platform gets, and where
the compile cache goes."""

import dataclasses
import os
import subprocess
import sys

import pytest

from gencast_tpu import configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('preset,platform,want', [
    ('1deg', 'gpu', 'pallas'),
    ('0.25deg', 'gpu', 'pallas'),
    ('nano', 'gpu', 'pallas'),
    ('tiny', 'gpu', 'pallas'),
    ('1deg', 'cpu', 'triblock'),
    ('0.25deg', 'cpu', 'triblock'),
    ('nano', 'cpu', 'triblock'),
])
def test_auto_attention_by_platform(preset, platform, want):
  assert configs.attention_type_for(configs.SPECS[preset],
                                    platform) == want


@pytest.mark.parametrize('explicit', ['triblock', 'dense', 'pallas'])
def test_explicit_attention_type_is_kept(explicit):
  spec = dataclasses.replace(configs.ONE_DEG, attention_type=explicit)
  for platform in ('gpu', 'cpu'):
    assert configs.attention_type_for(spec, platform) == explicit


def test_statics_follow_the_backend():
  """'pallas' builds a tile plan and no tri-block mask; 'triblock' the
  opposite."""
  pal = configs.build_statics(dataclasses.replace(
      configs.TINY, attention_type='pallas', attention_tile_size=32),
      cache_dir=None)
  assert pal.attention_tile_plan is not None
  assert pal.attention_tile_plan.tile == 32 and pal.attention_mask is None
  tri = configs.build_statics(configs.TINY, cache_dir=None)
  assert tri.attention_tile_plan is None and tri.attention_mask is not None


def _cache_dir(env_value):
  """The cache directory a fresh process ends up with after importing the
  package, run from outside the checkout."""
  env = {k: v for k, v in os.environ.items()
         if k != 'JAX_COMPILATION_CACHE_DIR'}
  env['PYTHONPATH'] = ROOT
  if env_value is not None:
    env['JAX_COMPILATION_CACHE_DIR'] = env_value
  code = ('import jax, gencast_tpu; '
          'print(jax.config.jax_compilation_cache_dir)')
  r = subprocess.run([sys.executable, '-c', code], env=env, cwd='/',
                     capture_output=True, text=True, timeout=120,
                     check=True)
  return r.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_the_checkout():
  assert _cache_dir(None) == os.path.join(ROOT, '.jax_cache')


def test_compile_cache_honours_the_environment(tmp_path):
  assert _cache_dir(str(tmp_path)) == str(tmp_path)
