// Explorer SPA (from scratch, dependency-free).
//
// State lives in the URL hash: #/steps/<fp>/<fp>/... — the same bookmarkable
// fingerprint-path scheme the reference UI uses. Each render fetches
// /.states/<path> for the next-step views and keeps a client-side list of the
// action labels chosen so far (rebuilt prefix-by-prefix on cold loads).

"use strict";

const $ = (id) => document.getElementById(id);
let steps = [];        // [{fp, action, state}] chosen so far
let views = [];        // next-step views at the current position
let selected = 0;

function hashFps() {
  const m = location.hash.match(/^#\/steps\/?(.*)$/);
  if (!m || !m[1]) return [];
  return m[1].split("/").filter(Boolean);
}

async function fetchViews(fps) {
  const res = await fetch("/.states/" + fps.join("/"));
  if (!res.ok) throw new Error("bad path");
  return res.json();
}

async function rebuild() {
  // Rebuild breadcrumb labels by replaying prefixes (cold load / back nav).
  const fps = hashFps();
  steps = [];
  let prefix = [];
  for (const fp of fps) {
    const vs = await fetchViews(prefix);
    const v = vs.find((x) => x.fingerprint === fp);
    steps.push({ fp, action: v ? v.action : "?", state: v ? v.state : "" });
    prefix = prefix.concat([fp]);
  }
  views = await fetchViews(fps);
  selected = 0;
  render();
}

function render() {
  const pathEl = $("path");
  pathEl.innerHTML = "";
  steps.forEach((s, i) => {
    const li = document.createElement("li");
    const a = document.createElement("a");
    a.textContent = s.action || "(init)";
    a.onclick = () => {
      location.hash = "#/steps/" + steps.slice(0, i + 1).map((x) => x.fp).join("/");
    };
    li.appendChild(a);
    pathEl.appendChild(li);
  });
  $("state").textContent = steps.length
    ? steps[steps.length - 1].state
    : "(choose an initial state below)";

  const stepsEl = $("steps");
  stepsEl.innerHTML = "";
  views.forEach((v, i) => {
    const li = document.createElement("li");
    li.className = v.ignored ? "ignored" : i === selected ? "selected" : "";
    const label = document.createElement("span");
    label.textContent = v.action || "(init state) " + v.state;
    li.appendChild(label);
    if (v.outcome) {
      const o = document.createElement("span");
      o.className = "outcome";
      o.textContent = v.outcome;
      li.appendChild(o);
    }
    // Per-state property verdicts as inline chips. Only an unsatisfied
    // ALWAYS is a violation; an unsatisfied sometimes/eventually condition
    // on an intermediate state is simply "not (yet) witnessed here".
    if (!v.ignored && v.properties && v.properties.length) {
      const chips = document.createElement("span");
      chips.className = "chips";
      for (const p of v.properties) {
        const c = document.createElement("span");
        const cls = p.satisfied
          ? "ok"
          : p.expectation === "always"
            ? "bad"
            : "idle";
        c.className = "chip " + cls;
        c.title = `${p.expectation} "${p.name}": ` +
          (p.satisfied
            ? "holds here"
            : p.expectation === "always"
              ? "VIOLATED here"
              : "not witnessed here");
        c.textContent = p.name;
        chips.appendChild(c);
      }
      li.appendChild(chips);
    }
    if (!v.ignored) li.onclick = () => follow(i);
    stepsEl.appendChild(li);
  });

  // Sequence diagram of the SELECTED next step (path + that step);
  // follows j/k selection like the reference's diagram pane.
  const svgHost = $("svg");
  svgHost.innerHTML = "";
  const sel = views[selected] && !views[selected].ignored
    ? views[selected]
    : views.find((v) => v.svg);
  if (sel && sel.svg) svgHost.innerHTML = sel.svg;

  // Preview of the selected successor state.
  const preview = $("preview");
  if (preview) {
    preview.textContent =
      sel && sel.state ? sel.state : "";
  }
}

function follow(i) {
  const v = views[i];
  if (!v || v.ignored) return;
  location.hash = "#/steps/" + steps.map((x) => x.fp).concat([v.fingerprint]).join("/");
}

async function refreshStatus() {
  try {
    const s = await (await fetch("/.status")).json();
    $("status").textContent =
      `${s.model} — states=${s.state_count} unique=${s.unique_state_count} ` +
      `depth=${s.max_depth}${s.done ? " (done)" : ""}`;
    const props = $("properties");
    props.innerHTML = "";
    for (const p of s.properties) {
      const li = document.createElement("li");
      const verdictOk =
        p.expectation === "sometimes" ? p.discovery !== null : p.discovery === null;
      li.className = p.discovery === null && p.expectation === "sometimes"
        ? "pending" : verdictOk ? "ok" : "bad";
      li.textContent = `${p.expectation} "${p.name}"`;
      if (p.discovery) {
        const a = document.createElement("a");
        a.textContent = p.classification || "discovery";
        a.href = "#/steps/" + p.discovery;
        li.appendChild(a);
      }
      props.appendChild(li);
    }
  } catch (e) {
    $("status").textContent = "disconnected";
  }
}

document.addEventListener("keydown", (e) => {
  if (e.key === "j") { selected = Math.min(selected + 1, views.length - 1); render(); }
  else if (e.key === "k") { selected = Math.max(selected - 1, 0); render(); }
  else if (e.key === "Enter") follow(selected);
  else if (e.key === "u" || e.key === "Backspace") {
    location.hash = "#/steps/" + steps.slice(0, -1).map((x) => x.fp).join("/");
  } else if (e.key === "Home") location.hash = "#/steps";
});

$("run").onclick = () => fetch("/.runtocompletion", { method: "POST" });
window.addEventListener("hashchange", rebuild);
rebuild().catch(() => { $("state").textContent = "failed to load"; });
refreshStatus();
setInterval(refreshStatus, 2000);
