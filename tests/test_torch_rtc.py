"""`incubator_mxnet_torch.rtc` on the CPU: signatures and their C types,
the checks made before any launch, dispatch by context, the compile
cache (with nvcc stubbed: this machine has none), and the JAX package's
own rtc tests run through both packages on the same seeded inputs: the
JAX `PallasKernel` in interpret mode, the port's `CudaKernel` through
its plain version (`cpu_fn`).

Tolerances: exact (float32 x * 2 + 1 and x + y are correctly rounded on
both sides).
"""
import ctypes

import numpy as np
import pytest
import torch

import jax
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.rtc import PallasKernel, PallasModule

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import nd, rtc

SRC = r"""
extern "C" __global__ void double_plus_one(const float *x, float *y,
                                           int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.f + 1.f;
}
template <typename T>
__global__ void add(const T *x, const T *y, T *o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + y[i];
}
"""
DPO_SIG = "const float *x, float *y, int64_t n"


def _dpo_plain(x, y, n):
    y.copy_(x * 2 + 1)


def _add_plain(x, y, o, n):
    o.copy_(x + y)


# ------------------------------------------------------- signatures
@pytest.mark.parametrize("sig,want", [
    ("const float *x, float *y, int n",
     [("float", True, True, "x"), ("float", True, False, "y"),
      ("int", False, False, "n")]),
    ("const float*, const float*, const int, const int",
     [("float", True, True, None), ("float", True, True, None),
      ("int", False, True, None), ("int", False, True, None)]),
    ("__nv_bfloat16 *__restrict__ y, int64_t n, __half h",
     [("__nv_bfloat16", True, False, "y"), ("int64_t", False, False, "n"),
      ("__half", False, False, "h")]),
    ("double* a, int8_t b, uint8_t *c, char d, int32_t e",
     [("double", True, False, "a"), ("int8_t", False, False, "b"),
      ("uint8_t", True, False, "c"), ("char", False, False, "d"),
      ("int32_t", False, False, "e")]),
    ("", []),
])
def test_parse_valid_signatures(sig, want):
    assert [tuple(p) for p in rtc.parse_signature(sig)] == want


@pytest.mark.parametrize("sig", [
    "long x", "unsigned int n", "float x y", "float &x", "float **x",
    "const float *x,", "float x[4]", "int, , int", "bool flag"])
def test_parse_invalid_signatures_raise(sig):
    with pytest.raises(mx.MXNetError, match="invalid kernel signature"):
        rtc.parse_signature(sig)


@pytest.mark.parametrize("ctype,dtype,scalar,size", [
    ("float", torch.float32, ctypes.c_float, 4),
    ("double", torch.float64, ctypes.c_double, 8),
    ("__half", torch.float16, ctypes.c_uint16, 2),
    ("__nv_bfloat16", torch.bfloat16, ctypes.c_uint16, 2),
    ("int", torch.int32, ctypes.c_int32, 4),
    ("int32_t", torch.int32, ctypes.c_int32, 4),
    ("int64_t", torch.int64, ctypes.c_int64, 8),
    ("int8_t", torch.int8, ctypes.c_int8, 1),
    ("uint8_t", torch.uint8, ctypes.c_uint8, 1),
    ("char", torch.int8, ctypes.c_int8, 1)])
def test_c_type_table(ctype, dtype, scalar, size):
    """Each C type's tensor dtype, and a scalar packed in exactly the C
    type's width (an int64_t packed as a 4-byte int would shift every
    later argument)."""
    assert rtc.C_TYPES[ctype] == (dtype, scalar)
    assert ctypes.sizeof(scalar) == size == torch.empty(0, dtype=dtype) \
        .element_size()


def _kernel(sig, cpu_fn=None):
    return rtc.CudaKernel(rtc.CudaModule("", exports=("k",)), "k",
                          rtc.parse_signature(sig), cpu_fn)


def test_scalars_are_packed_in_their_c_type():
    k = _kernel("int64_t a, int b, float c, __nv_bfloat16 d, __half e, "
                "uint8_t f")
    vals = k._values([2 ** 40 + 3, -7, 0.1, 1.5, 0.333, 255],
                     torch.device("cpu"))
    assert [type(v) for v in vals] == [ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_float, ctypes.c_uint16,
                                       ctypes.c_uint16, ctypes.c_uint8]
    assert vals[0].value == 2 ** 40 + 3 and vals[1].value == -7
    assert vals[2].value == np.float32(0.1)
    assert vals[3].value == int(torch.tensor(1.5, dtype=torch.bfloat16)
                                .view(torch.int16)) == 0x3FC0
    assert vals[4].value == int(np.float16(0.333).view(np.uint16))
    assert vals[5].value == 255


@pytest.mark.parametrize("sig,arg,match", [
    ("int n", 2 ** 31, "does not fit int"),
    ("uint8_t n", -1, "does not fit uint8_t"),
    ("int64_t n", 2 ** 63, "does not fit int64_t"),
    ("int n", 1.5, "is int"),
    ("float a", "2", "pass a number"),
    ("float a", torch.tensor(1.0), "pass a number"),
    ("float *x", 1.0, "pass an NDArray"),
])
def test_scalar_and_pointer_checks(sig, arg, match):
    with pytest.raises(mx.MXNetError, match=match):
        _kernel(sig, _dpo_plain).launch([arg], mx.cpu(), (1,), (1,))


# ------------------------------------------- errors before any launch
def _dpo(cpu_fn=_dpo_plain):
    return rtc.CudaModule(SRC).get_kernel("double_plus_one", DPO_SIG,
                                          cpu_fn=cpu_fn)


def _xy(n=8, dtype=torch.float32):
    x = torch.arange(n, dtype=torch.float32).to(dtype)
    return x, torch.zeros(n, dtype=dtype)


@pytest.mark.parametrize("case", [
    "dtype", "arity", "scalar_for_pointer", "noncontiguous", "off_ctx",
    "grid_zero", "block_threads", "grid_4d", "grid_float", "block_z",
    "shared_mem"])
def test_bad_launches_raise_before_running(case):
    calls = []
    k = _dpo(lambda *a: calls.append(a))
    x, y = _xy()
    args, grid, block, kw = [x, y, 8], (1, 1, 1), (8, 1, 1), {}
    if case == "dtype":
        args[0] = x.double()
    elif case == "arity":
        args = [x, y]
    elif case == "scalar_for_pointer":
        args[1] = 3
    elif case == "noncontiguous":
        args[0] = torch.zeros(8, 2)[:, 0]
    elif case == "off_ctx":
        args[1] = torch.zeros(8, device="meta")
    elif case == "grid_zero":
        grid = (0, 1, 1)
    elif case == "block_threads":
        block = (64, 32, 1)
    elif case == "grid_4d":
        grid = (1, 1, 1, 1)
    elif case == "grid_float":
        grid = (1.0, 1, 1)
    elif case == "block_z":
        block = (1, 1, 65)
    elif case == "shared_mem":
        kw = {"shared_mem": rtc.MAX_SHARED_MEM + 1}
    with pytest.raises(mx.MXNetError):
        k.launch(args, mx.cpu(), grid, block, **kw)
    assert calls == []


def test_unknown_kernel_name_raises_key_error_before_any_compile(
        monkeypatch):
    monkeypatch.setattr(rtc, "_run_nvcc", lambda args: pytest.fail("nvcc"))
    mod = rtc.CudaModule(SRC, exports=("add<float>",))
    assert mod.kernel_names == ("double_plus_one", "add<float>")
    for name in ("nope", "add", "add<double>"):
        with pytest.raises(KeyError, match="no kernel"):
            mod.get_kernel(name, "")
        with pytest.raises(mx.MXNetError):
            mod.get_kernel(name, "")


def test_global_kernel_names_skip_comments_templates_and_bounds():
    src = """
    // __global__ void in_a_comment(int)
    /* __global__ void in_a_block_comment(int) */
    template <int N> __global__ void tmpl(float *x) {}
    __global__ void __launch_bounds__(256, 2) bounded(float *x) {}
    __global__ void declared(int);
    static __global__ void declared(int n) {}
    __device__ float helper(float x) { return x; }
    """
    assert rtc._global_kernels(src) == ["bounded", "declared"]


# --------------------------------------------------------- dispatch
def test_cpu_context_without_cpu_fn_raises():
    k = _dpo(cpu_fn=None)
    with pytest.raises(mx.MXNetError, match="cpu_fn"):
        k.launch(list(_xy()) + [8], mx.cpu(), (1,), (8,))


def test_cuda_context_never_falls_back_to_the_plain_version(monkeypatch):
    """Without a card a gpu context raises; the plain version is not
    run in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    k = _dpo(lambda *a: calls.append(a))
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        k.launch(list(_xy()) + [8], mx.gpu(0), (1,), (8,))
    assert calls == []


def test_cpu_launch_writes_in_place_and_counts_no_launch():
    rtc.reset_launch_counts()
    k = _dpo()
    with mx.cpu():
        x, y = nd.array(np.arange(8, dtype=np.float32)), nd.zeros(8)
    k.launch([x, y, 8], mx.cpu(), (1, 1, 1), (8, 1, 1))
    np.testing.assert_array_equal(y.asnumpy(), np.arange(8) * 2 + 1)
    assert rtc.launch_counts["double_plus_one"] == 0


# ----------------------------------------------------- compile cache
@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """nvcc replaced by a stub that counts its runs and writes an empty
    library; the build directory is a fresh temporary one."""
    runs = []

    def run(args):
        runs.append(args)
        with open(args[args.index("-o") + 1], "wb") as f:
            f.write(b"\0")
        return 0, ""
    monkeypatch.setattr(rtc, "BUILD_DIR", str(tmp_path / "rtc"))
    monkeypatch.setattr(rtc, "_run_nvcc", run)
    return runs


def test_same_source_builds_once_edited_source_builds_again(stub_nvcc):
    a = rtc.CudaModule(SRC, exports=("add<float>",))
    path = a.build()
    assert len(stub_nvcc) == 1
    assert rtc.CudaModule(SRC, exports=("add<float>",)).build() == path
    assert len(stub_nvcc) == 1                       # cached on disk
    for other in (rtc.CudaModule(SRC.replace("2.f", "3.f"),
                                 exports=("add<float>",)),
                  rtc.CudaModule(SRC, exports=("add<float>", "add<int>")),
                  rtc.CudaModule(SRC, options=("--use_fast_math",),
                                 exports=("add<float>",))):
        assert other.build() != path
    assert len(stub_nvcc) == 4
    args = stub_nvcc[-1]
    assert "arch=compute_90a,code=sm_90a" in args
    assert "--use_fast_math" in args
    with open(args[-1]) as f:
        text = f.read()
    assert text.startswith(rtc.PRELUDE)
    assert "(const void *)&double_plus_one;" in text
    assert "(const void *)&add<float>;" in text
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in text


def test_compile_error_raises_with_the_compiler_log(tmp_path, monkeypatch):
    monkeypatch.setattr(rtc, "BUILD_DIR", str(tmp_path / "rtc"))
    monkeypatch.setattr(rtc, "_run_nvcc", lambda args: (
        1, "rtc.cu(3): error: expected a \";\""))
    mod = rtc.CudaModule("__global__ void broken(int n) { n++ }")
    with pytest.raises(mx.MXNetError, match='expected a ";"'):
        mod.build()
    assert not [p for p in (tmp_path / "rtc").iterdir()
                if p.suffix == ".so"]


# ----------------------------- the JAX package's rtc tests, both sides
def test_rtc_custom_kernel_launch_matches_jax():
    def double_plus_one(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2 + 1

    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    jmod = PallasModule()
    jk = jmod.add_kernel(double_plus_one, out_shape=lambda a:
                         jax.ShapeDtypeStruct(a.shape, a.dtype),
                         interpret=True)
    ref = jk.launch(mxj.nd.array(x, ctx=mxj.cpu())).asnumpy()
    mod = rtc.CudaModule(SRC)
    k = mod.get_kernel("double_plus_one", DPO_SIG, cpu_fn=_dpo_plain)
    with mx.cpu():
        tx, ty = nd.array(x), nd.zeros(x.shape)
    k.launch([tx, ty, x.size], mx.cpu(), (1, 1, 1), (32, 1, 1))
    np.testing.assert_array_equal(ty.asnumpy(), ref)
    assert jmod.get_kernel("double_plus_one") is jk
    with pytest.raises(KeyError):
        jmod.get_kernel("nope")
    with pytest.raises(KeyError):
        mod.get_kernel("nope", DPO_SIG)


def test_rtc_kernel_signature_cache_matches_jax(stub_nvcc):
    """The JAX kernel compiles once per input signature; the port's
    module compiles once whatever the shapes, and both give x + y."""
    def add(x_ref, y_ref, o_ref):
        o_ref[:] = x_ref[:] + y_ref[:]

    jk = PallasKernel(add, out_shape=lambda a, b:
                      jax.ShapeDtypeStruct(a.shape, a.dtype), interpret=True)
    mod = rtc.CudaModule(SRC, exports=("add<float>",))
    k = mod.get_kernel("add<float>", "const float *x, const float *y, "
                       "float *o, int n", cpu_fn=_add_plain)
    rng = np.random.RandomState(1)
    for i, shape in enumerate([(4, 4), (8, 8)]):
        a, b = (rng.randn(*shape).astype(np.float32) for _ in range(2))
        ref = jk(mxj.nd.array(a, ctx=mxj.cpu()),
                 mxj.nd.array(b, ctx=mxj.cpu())).asnumpy()
        assert len(jk._cache) == i + 1
        with mx.cpu():
            ta, tb, to = nd.array(a), nd.array(b), nd.zeros(shape)
        k.launch([ta, tb, to, a.size], mx.cpu(), (1,), (64,))
        np.testing.assert_array_equal(to.asnumpy(), ref)
    mod.build()
    mod.build()
    assert len(stub_nvcc) == 1
