"""``scripts/port_ab.py``'s turn order, which needs no card: parent,
change, change, parent, ... cut to ``--turns`` turns of each tree, so that
every count from 1 runs each tree (the ``hash`` part needs one turn a side)
and a count below 1 is refused."""

import importlib.util
import os

import pytest

PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                    "port_ab.py")


@pytest.fixture(scope="module")
def port_ab():
    spec = importlib.util.spec_from_file_location("port_ab", PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("turns,want", [
    (1, ["parent", "change"]),
    (2, ["parent", "change", "change", "parent"]),
    (3, ["parent", "change", "change", "parent", "parent", "change"]),
    (4, ["parent", "change", "change", "parent"] * 2),
])
def test_turn_order(port_ab, turns, want):
    order = port_ab.turn_order(turns)
    assert order == want
    assert order.count("parent") == order.count("change") == turns
    assert order[0] == "parent" and "change" in order


@pytest.mark.parametrize("turns", [0, -1])
def test_turn_order_refuses_no_turn(port_ab, turns):
    with pytest.raises(ValueError, match="at least 1"):
        port_ab.turn_order(turns)


@pytest.mark.parametrize("name,port", [
    ("void fd::(anonymous namespace)::dq_kernel<float, 64>(fd::FlashArgs)", True),
    ("(anonymous namespace)::gn_apply_kernel(float const*, float*)", True),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, float, 10, false>(float*)",
     False),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", False),
])
def test_port_kernel_rule(port_ab, name, port):
    """A profiler name is the port's only in the port's namespaces and as a
    ``__global__`` function of the tree's sources, as in chip_smoke."""
    import chip_smoke

    tree = os.path.dirname(os.path.dirname(PATH))
    names = port_ab._port_names(tree)
    assert names == chip_smoke.PORT_KERNEL_NAMES
    assert port_ab._is_port(name, names) is port
    assert chip_smoke.is_port_kernel(name) is port
