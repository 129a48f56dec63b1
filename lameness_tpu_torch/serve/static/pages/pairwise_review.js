// PairwiseReview.tsx (738 LoC): tutorial-gated 7-point pairwise
// comparison flow — synced dual players, keyboard shortcuts (1-7 scale,
// space play/pause, Enter submit), Elo active-sampled pairs, progress
// bar, toggleable EloSteepness ranking panel, deep-linkable pairs.
import {api, h, main, fmt, pct, esc, short, table, toast} from "/static/app.js";

// 7-point comparison scale per the DSI spec (PairwiseReview.tsx:15-23)
const SCALE = [
  [-3, "A much more lame", "var(--bad)"],
  [-2, "A more lame", "var(--bad)"],
  [-1, "A slightly more lame", "var(--warn)"],
  [0, "Equal / cannot decide", "var(--dim)"],
  [1, "B slightly more lame", "var(--warn)"],
  [2, "B more lame", "var(--bad)"],
  [3, "B much more lame", "var(--bad)"],
];

const scaleButtons = (sel) => SCALE.map(([v, label], i) =>
  `<button class="mini scale-btn" data-v="${v}" style="${sel === v
     ? "outline:2px solid var(--accent);" : ""}border-left:3px solid ${
     SCALE[i][2]}"><span class="dim">${i + 1}</span> ${label}</button>`)
  .join("");

export default async function PairwiseReview(pinId1, pinId2) {
  // tutorial gate (PairwiseReview.tsx:54-63): first visit walks gold
  // tutorial examples; completion is remembered locally
  if (!pinId1 && localStorage.getItem("pairwise_tutorial_complete") !== "true") {
    let ex = [];
    try { ex = (await api("/api/tutorial/examples")).examples || []; }
    catch (e) { /* fall through to real comparisons */ }
    if (ex.length) return tutorial(ex);
    localStorage.setItem("pairwise_tutorial_complete", "true");
  }

  let pair;
  if (pinId1 && pinId2) {
    pair = {video_id_1: pinId1, video_id_2: pinId2, strategy: "shared link"};
  } else {
    try { pair = await api("/api/elo/next-pair"); }
    catch (e) {
      return main.append(h(`<div class="panel">${esc(e.message)}
        — upload at least two videos first.</div>`));
    }
  }
  const stats = await api("/api/elo/stats").catch(() => ({}));
  if (pair.status === "all_completed") {
    return main.append(h(`<div class="panel" style="text-align:center">
      <h2>All comparisons complete 🎉</h2>
      <div class="dim">You've completed all ${pair.total_pairs} pairwise
        comparisons.</div>
      <button class="action" onclick="go('hierarchy')" style="margin-top:10px">
        View lameness ranking</button></div>`));
  }

  let selected = null;
  main.append(h(`<div class="panel"><h2>Pairwise comparison
      <span class="dim">7-point scale · strategy: ${esc(pair.strategy || "")}
      </span>
      <button class="mini" id="toggle-rank">show ranking</button>
      <button class="mini" id="share">share pair</button>
      <button class="mini" id="retake">retake tutorial</button></h2>
    ${stats.total_possible_pairs ? `<div class="row">
      <div class="bar" style="flex:1"><i style="width:${
        100 * (stats.completion_rate || 0)}%"></i></div>
      <span class="dim">${stats.unique_pairs_compared} /
        ${stats.total_possible_pairs} pairs
        (${pct(stats.completion_rate)})</span></div>` : ""}
    <div id="rank-panel" style="display:none"></div>
    <div class="vs">
      <div class="panel"><div class="dim">Video A</div>
        <video id="vid-a" muted loop
          src="/api/videos/${pair.video_id_1}/stream"></video></div>
      <div class="panel"><div class="dim">Video B</div>
        <video id="vid-b" muted loop
          src="/api/videos/${pair.video_id_2}/stream"></video></div></div>
    <div class="row" style="justify-content:center;margin:6px 0">
      <button class="mini" id="restart">⟲ restart</button>
      <button class="mini" id="playpause">▶ / ⏸ (space)</button></div>
    <div class="row" id="scale-row" style="justify-content:center;flex-wrap:wrap">
      ${scaleButtons(null)}</div>
    <div class="row" style="justify-content:center;margin-top:8px">
      <button class="action" id="submit" disabled>Submit (Enter)</button>
      <button class="mini" id="skip">skip pair</button></div>
    <div id="feedback" class="dim" style="text-align:center"></div></div>`));

  const va = document.getElementById("vid-a");
  const vb = document.getElementById("vid-b");
  // keep the two players in lockstep (PairwiseReview.tsx:211-225)
  va.ontimeupdate = () => {
    if (Math.abs(va.currentTime - vb.currentTime) > 0.1)
      vb.currentTime = va.currentTime;
  };
  const playpause = () => {
    if (va.paused) { va.play(); vb.play(); }
    else { va.pause(); vb.pause(); }
  };
  document.getElementById("playpause").onclick = playpause;
  document.getElementById("restart").onclick = () => {
    va.currentTime = vb.currentTime = 0; va.play(); vb.play();
  };

  const select = (v) => {
    selected = v;
    document.getElementById("scale-row").innerHTML = scaleButtons(v);
    wireScale();
    document.getElementById("submit").disabled = false;
  };
  const wireScale = () => {
    for (const b of document.querySelectorAll(".scale-btn"))
      b.onclick = () => select(+b.dataset.v);
  };
  wireScale();

  // 7-point value -> winner / degree / confidence (tsx:149-167)
  const submit = async () => {
    if (selected === null) return;
    const winner = selected < 0 ? 1 : selected > 0 ? 2 : 0;
    const degree = Math.abs(selected);
    const confidence = degree === 3 ? "very_confident"
      : degree === 2 ? "confident" : "uncertain";
    try {
      const r = await api("/api/elo/comparison", {json: {
        video_id_1: pair.video_id_1, video_id_2: pair.video_id_2,
        winner, degree: Math.max(degree, 1), confidence,
        raw_score: selected}});
      toast(`Elo: A ${fmt(r.video_id_1.rating, 0)} vs B ${
        fmt(r.video_id_2.rating, 0)}`);
      window.go("pairwise");
    } catch (e) { toast(e.message, "bad"); }
  };
  document.getElementById("submit").onclick = submit;
  document.getElementById("skip").onclick = () => window.go("pairwise");
  document.getElementById("retake").onclick = () => {
    localStorage.removeItem("pairwise_tutorial_complete");
    window.go("pairwise");
  };
  document.getElementById("share").onclick = async () => {
    const url = `${location.origin}/#pairwise/${pair.video_id_1}/${
      pair.video_id_2}`;
    try { await navigator.clipboard.writeText(url); toast("link copied"); }
    catch (e) { document.getElementById("feedback").textContent = url; }
  };
  document.onkeydown = (e) => {
    if (/INPUT|SELECT|TEXTAREA/.test(e.target.tagName)) return;
    const k = +e.key;
    if (k >= 1 && k <= 7) select(SCALE[k - 1][0]);
    else if (e.key === " ") { e.preventDefault(); playpause(); }
    else if (e.key === "Enter") submit();
  };

  // ranking panel: Elo table + steepness metrics (tsx:503-556)
  let rankLoaded = false;
  document.getElementById("toggle-rank").onclick = async (ev) => {
    const panel = document.getElementById("rank-panel");
    const show = panel.style.display === "none";
    panel.style.display = show ? "" : "none";
    ev.target.textContent = show ? "hide ranking" : "show ranking";
    if (show && !rankLoaded) {
      rankLoaded = true;
      const [ranking, hier] = await Promise.all([
        api("/api/training/pairwise/ranking")
          .then(r => r.ranking || []).catch(() => []),
        api("/api/elo/hierarchy").catch(() => null)]);
      panel.innerHTML = `<h3>Lameness hierarchy
        <span class="dim">higher Elo = more lame${hier
          ? ` · steepness ${fmt(hier.steepness, 2)} ·
             ${hier.total_comparisons} comparisons` : ""}</span></h3>` +
        (ranking.length ? table(ranking.slice(0, 15), [
          ["#", r => r.rank_position ?? "—"],
          ["video", r => `<span class="dim">${short(r.video_id, 12)}</span>`],
          ["elo", r => `<b class="${r.elo_rating > 1550 ? "bad"
            : r.elo_rating < 1450 ? "ok" : ""}">${fmt(r.elo_rating, 0)}</b>`],
          ["±", r => fmt(r.elo_uncertainty, 0)],
          ["w/l/t", r => `${r.wins}/${r.losses}/${r.ties}`]])
        : `<span class="dim">no comparisons yet — start voting</span>`);
    }
  };
}

// tutorial walk-through (PairwiseReview.tsx:276-418): per-step pair,
// 7-point answer, hint feedback, score, skip; gold answer maps
// correct_winner/correct_degree onto the signed scale value
function tutorial(examples) {
  let step = 0, score = 0, selected = null, revealed = false;

  const render = () => {
    main.innerHTML = "";
    const ex = examples[step];
    const answer = ex.correct_winner === 0 ? 0
      : (ex.correct_winner === 1 ? -1 : 1) * (ex.correct_degree || 2);
    main.append(h(`<div class="panel">
      <h2>Tutorial: learn to assess lameness
        <span class="dim">step ${step + 1} of ${examples.length}
          · score ${score}</span></h2>
      <div class="bar"><i style="width:${
        100 * (step + 1) / examples.length}%"></i></div>
      <div class="dim" style="margin:6px 0">${esc(ex.description || "")}</div>
      <div class="vs">
        <div class="panel"><div class="dim">Video A</div>
          <video controls autoplay muted loop
            src="/api/videos/${ex.video_id_1}/stream"></video></div>
        <div class="panel"><div class="dim">Video B</div>
          <video controls autoplay muted loop
            src="/api/videos/${ex.video_id_2}/stream"></video></div></div>
      <div class="row" id="scale-row" style="justify-content:center;flex-wrap:wrap">
        ${scaleButtons(selected)}</div>
      <div id="tut-feedback" style="text-align:center;margin-top:8px">
        ${revealed ? (selected === answer
          ? `<b class="ok">✓ Correct!</b>`
          : `<b class="warn">○ Not quite right</b>`) : ""}
        ${revealed && ex.hint ? `<div class="dim">${esc(ex.hint)}</div>` : ""}
      </div>
      <div class="row" style="justify-content:center;margin-top:8px">
        ${revealed
          ? `<button class="action" id="tut-next">${
              step < examples.length - 1 ? "Next example"
              : "Start real comparisons"}</button>`
          : `<button class="action" id="tut-check"
               ${selected === null ? "disabled" : ""}>Check answer</button>`}
        <button class="mini" id="tut-skip">skip tutorial</button></div>
      </div>`));
    for (const b of document.querySelectorAll(".scale-btn"))
      b.onclick = () => { if (!revealed) { selected = +b.dataset.v; render(); } };
    const check = document.getElementById("tut-check");
    if (check) check.onclick = () => {
      if (selected === answer) score += 1;
      revealed = true; render();
    };
    const next = document.getElementById("tut-next");
    if (next) next.onclick = () => {
      if (step < examples.length - 1) {
        step += 1; selected = null; revealed = false; render();
      } else {
        localStorage.setItem("pairwise_tutorial_complete", "true");
        window.go("pairwise");
      }
    };
    document.getElementById("tut-skip").onclick = () => {
      localStorage.setItem("pairwise_tutorial_complete", "true");
      window.go("pairwise");
    };
  };
  render();
}
