"""setup_s (s): from process start to the window's start: imports, CUDA
init, the kernel library's load or build, data, insert, index build,
captures and warm-up."""


def read(obs):
    return obs["setup_s"]
